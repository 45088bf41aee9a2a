"""The port's native layer sink and pgzip codec against the JAX package's.

The port builds ``makisu_tpu_torch/csrc/*.cpp`` with g++ on first use
(this host has g++ and zlib). On the same seeded bytes:
``native.LayerSinkHandle`` writes the blob ``makisu_tpu.native``'s
handle writes, at zlib levels 1/6/9 and pgzip-6 on 1/3/8 lanes;
``NativeLayerSink`` gives the digests and blob of the port's Python
``LayerSink``; ``GPUHasher(device="cpu")`` through the native sink gives
the chunk list of the reference's ``TPUHasher`` on CPU JAX. The Python
sink is taken for zlib-0, in-memory outputs and
``MAKISU_TPU_NATIVE_SINK=0``; a tap error fails the commit; a source
that does not compile raises with the compiler's output.
"""

import gzip
import hashlib
import io
import os
import tarfile

import numpy as np
import pytest

from makisu_tpu import native as ref_native
from makisu_tpu.chunker import TPUHasher
from makisu_tpu.chunker import hasher as ref_hasher
from makisu_tpu_torch import native, tario
from makisu_tpu_torch.chunker import GPUHasher, LayerSink, hasher
from makisu_tpu_torch.ops import _build
from makisu_tpu_torch.utils import concurrency

BACKENDS = [("zlib", 1, 1), ("zlib", 6, 1), ("zlib", 9, 1),
            ("pgzip", 6, 1), ("pgzip", 6, 3), ("pgzip", 6, 8)]


def stream(n: int, seed: int) -> bytes:
    """Half text-like, half random bytes."""
    rng = np.random.default_rng(seed)
    words = rng.integers(97, 123, size=n, dtype=np.uint8)
    words[rng.random(n) < 0.15] = 32
    noise = rng.integers(0, 256, size=n, dtype=np.uint8)
    return bytes(np.where(np.arange(n) % 8192 < 4096, words, noise))


def make_files(root, seed=0, nfiles=30):
    """Seeded files on disk; returns [(path, tarinfo)] in commit order."""
    rng = np.random.default_rng(seed)
    entries = []
    for k in range(nfiles):
        size = int(rng.integers(0, 40_000)) if k % 9 else 300_000
        path = root / f"f{k:03d}.bin"
        path.write_bytes(stream(size, seed * 1000 + k))
        info = tarfile.TarInfo(f"app/f{k:03d}.bin")
        info.size = size
        info.mode = 0o644
        info.mtime = 1_700_000_000
        entries.append((str(path), info))
    return entries


def handle_blob(mod, path, data: bytes, backend: str, level: int,
                lanes: int, files=()):
    """Stream ``data`` (in uneven writes) and then ``files`` through
    ``mod.LayerSinkHandle`` into ``path``; returns (finish tuple, blob,
    tapped bytes)."""
    tapped = []
    with open(path, "wb") as out:
        h = mod.LayerSinkHandle(out.fileno(), backend, level,
                                mod.DEFAULT_BLOCK, nthreads=lanes)
        h.set_tap(tapped.append)
        steps = [1, 511, 70_000, 3, 262_145]
        i = k = 0
        while i < len(data):
            step = steps[k % len(steps)]
            h.write(data[i:i + step])
            i, k = i + step, k + 1
        for src, info in files:
            h.write_file(src, info.size)
        result = h.finish()
        h.close()
    return result, path.read_bytes(), b"".join(tapped)


@pytest.mark.parametrize("backend,level,lanes", BACKENDS,
                         ids=[f"{b}-{lv}-x{n}" for b, lv, n in BACKENDS])
def test_handle_matches_reference(tmp_path, backend, level, lanes):
    data = stream(1_300_000, seed=level)
    files = make_files(tmp_path, seed=lanes, nfiles=6)
    got = handle_blob(native, tmp_path / "port.gz", data, backend, level,
                      lanes, files)
    want = handle_blob(ref_native, tmp_path / "ref.gz", data, backend,
                       level, lanes, files)
    assert got == want
    (tar_hex, gz_hex, gz_size, tar_size), blob, tapped = got
    raw = data + b"".join(
        open(src, "rb").read() + b"\0" * ((-info.size) % 512)
        for src, info in files)
    assert tapped == raw and tar_size == len(raw)
    assert tar_hex == hashlib.sha256(raw).hexdigest()
    assert gz_hex == hashlib.sha256(blob).hexdigest()
    assert gz_size == len(blob) and gzip.decompress(blob) == raw


TAP_BATCH = 1 << 20  # csrc/layersink.cpp kTapBatch


def test_tap_hands_on_the_stream_in_batches(tmp_path):
    """The tap sees every byte in order, in pieces of at most
    TAP_BATCH bytes but for a single write larger than that."""
    pieces = []
    data = stream(3 * TAP_BATCH + 5, seed=2)
    with open(tmp_path / "out.gz", "wb") as out:
        h = native.LayerSinkHandle(out.fileno(), "zlib", 1)
        h.set_tap(pieces.append)
        for i in range(0, 2_000_000, 4096):
            h.write(data[i:min(i + 4096, 2_000_000)])
        h.write(data[2_000_000:])  # one write of more than TAP_BATCH
        h.finish()
        h.close()
    assert b"".join(pieces) == data
    assert [len(p) for p in pieces] == [
        TAP_BATCH, 2_000_000 - TAP_BATCH, len(data) - 2_000_000]
    assert h.native_seconds >= h.tap_seconds > 0


def write_layer(sink, entries, buffered: bool):
    """One layer through ``sink.open_tar()`` via ``tario.write_entry``
    (``add_path`` on the native writer; ``data`` when ``buffered``)."""
    with sink.open_tar() as tw:
        d = tarfile.TarInfo("app")
        d.type, d.mode, d.mtime = tarfile.DIRTYPE, 0o755, 1_700_000_000
        tw.addfile(d)
        for src, info in entries:
            data = open(src, "rb").read() if buffered else None
            tario.write_entry(tw, src, info, data=data)
    return sink.finish()


def python_commit(tmp_path, entries, backend_id, session_hasher=None):
    with open(tmp_path / "py.gz", "wb") as out:
        if session_hasher is None:
            sink = LayerSink(out, backend_id=backend_id)
        else:
            sink = hasher._GPUSink(
                out, hasher.ChunkSession(device="cpu"),
                backend_id=backend_id)
        commit = write_layer(sink, entries, buffered=False)
    return commit, (tmp_path / "py.gz").read_bytes()


@pytest.mark.parametrize("backend_id", ["zlib-1", "zlib-6", "zlib-9",
                                        "pgzip-6-131072", "pgzip-1-65536"])
def test_native_sink_matches_python_sink(tmp_path, backend_id):
    entries = make_files(tmp_path, seed=3)
    token = concurrency.set_compress_workers(3)
    try:
        with open(tmp_path / "native.gz", "wb") as out:
            sink = hasher.CPUHasher().open_layer(out, backend_id=backend_id)
            assert isinstance(sink, hasher.NativeLayerSink)
            assert sink.route == "native"
            got = write_layer(sink, entries, buffered=False)
        want, want_blob = python_commit(tmp_path, entries, backend_id)
    finally:
        concurrency.reset_compress_workers(token)
    assert got.digest_pair == want.digest_pair
    assert (tmp_path / "native.gz").read_bytes() == want_blob
    assert got.gzip_backend_id == want.gzip_backend_id == backend_id
    assert got.chunks == want.chunks == []


@pytest.mark.parametrize("backend_id", ["zlib-6", "pgzip-6-131072"])
def test_gpu_hasher_native_sink_matches_reference(tmp_path, monkeypatch,
                                                  backend_id):
    """The port's GPUHasher (plain versions on the CPU) through its
    native sink, the reference's TPUHasher (CPU JAX) through its own:
    the same commit, chunk list and blob; and the same chunks as the
    port's Python sink."""
    monkeypatch.setenv("MAKISU_TPU_CHUNK_NATIVE", "0")
    entries = make_files(tmp_path, seed=4, nfiles=24)
    commits, blobs = [], []
    for name, h in (("port", GPUHasher(device="cpu")), ("ref", TPUHasher())):
        path = tmp_path / f"{name}.gz"
        with open(path, "wb") as out:
            sink = h.open_layer(out, backend_id=backend_id)
            want_cls = (hasher.NativeLayerSink if name == "port"
                        else ref_hasher.NativeLayerSink)
            assert isinstance(sink, want_cls)
            commits.append(write_layer(sink, entries, buffered=False))
        blobs.append(path.read_bytes())
    got, want = commits
    assert str(got.digest_pair.tar_digest) == \
        str(want.digest_pair.tar_digest)
    assert blobs[0] == blobs[1]
    assert [(c.offset, c.length, c.hex_digest) for c in got.chunks] == \
        [(c.offset, c.length, c.hex_digest) for c in want.chunks]
    assert len(got.chunks) > 5
    py, py_blob = python_commit(tmp_path, entries, backend_id,
                                session_hasher=True)
    assert py.chunks == got.chunks and py_blob == blobs[0]
    tar = gzip.decompress(blobs[0])
    assert all(hashlib.sha256(tar[c.offset:c.offset + c.length])
               .hexdigest() == c.hex_digest for c in got.chunks)


def test_python_sink_for_level0_memory_and_switch(tmp_path, monkeypatch):
    with open(tmp_path / "a.gz", "wb") as out:
        assert hasher.CPUHasher().open_layer(out, "zlib-6").route == \
            "native"
        assert hasher.CPUHasher().open_layer(out, "zlib-0").route == \
            "python"
        assert GPUHasher(device="cpu").open_layer(out, "zlib-0").route \
            == "python"
    assert hasher.CPUHasher().open_layer(io.BytesIO(), "zlib-6").route \
        == "python"
    assert GPUHasher(device="cpu").open_layer(io.BytesIO(), "zlib-6") \
        .route == "python"
    monkeypatch.setenv("MAKISU_TPU_NATIVE_SINK", "0")
    with open(tmp_path / "b.gz", "wb") as out:
        assert hasher.CPUHasher().open_layer(out, "zlib-6").route == \
            "python"
        assert GPUHasher(device="cpu").open_layer(out, "pgzip-6-131072") \
            .route == "python"
    # The reference decides alike.
    with open(tmp_path / "c.gz", "wb") as out:
        for backend_id in ("zlib-6", "zlib-0"):
            monkeypatch.delenv("MAKISU_TPU_NATIVE_SINK")
            assert hasher._use_native(out, backend_id) == \
                ref_hasher._use_native(out, backend_id)
            monkeypatch.setenv("MAKISU_TPU_NATIVE_SINK", "0")
            assert hasher._use_native(out, backend_id) == \
                ref_hasher._use_native(out, backend_id) is False


class _FailingSession:
    """A chunk session whose ``update`` raises once it has seen
    ``after`` bytes."""

    def __init__(self, after: int) -> None:
        self.after, self.seen = after, 0

    def update(self, data: bytes) -> None:
        self.seen += len(data)
        if self.seen > self.after:
            raise ValueError("tap broke")


def test_tap_error_surfaces_from_write_file(tmp_path):
    entries = make_files(tmp_path, seed=5, nfiles=40)
    assert sum(info.size for _, info in entries) > 2 * (1 << 20)
    with open(tmp_path / "out.gz", "wb") as out:
        h = native.LayerSinkHandle(out.fileno(), "zlib", 6)
        h.set_tap(_FailingSession(after=100_000).update)
        with pytest.raises(RuntimeError, match="tap failed") as err:
            for src, info in entries:
                h.write(info.tobuf(tarfile.PAX_FORMAT))
                h.write_file(src, info.size)
        assert isinstance(err.value.__cause__, ValueError)
        # Every later call re-raises: the layer cannot be finished.
        with pytest.raises(RuntimeError, match="tap failed"):
            h.finish()
        h.close()


def test_tap_error_surfaces_from_finish(tmp_path):
    """A tap that fails on the last piece (handed on by finish) fails
    the commit there, before the blob is finished."""
    data = stream(300_000, seed=6)
    with open(tmp_path / "out.gz", "wb") as out:
        sink = hasher.NativeLayerSink(out, "zlib-6",
                                      session=_FailingSession(200_000))
        sink.write(data)  # below TAP_BATCH: held until lsk_finish
        with pytest.raises(RuntimeError, match="tap failed"):
            sink.finish()


def test_session_error_fails_the_gpu_commit(tmp_path, monkeypatch):
    """A chunk session that raises mid-layer fails the commit through
    the native sink: no layer with missing chunks."""
    entries = make_files(tmp_path, seed=7, nfiles=10)

    def broken(self, data):
        raise RuntimeError("device lost")

    monkeypatch.setattr(hasher.ChunkSession, "update", broken)
    with open(tmp_path / "out.gz", "wb") as out:
        sink = GPUHasher(device="cpu").open_layer(out, "zlib-6")
        assert sink.route == "native"
        with pytest.raises(RuntimeError, match="tap failed"):
            write_layer(sink, entries, buffered=False)


def test_broken_source_raises_with_compiler_output(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in _build.HOST_SOURCES["pgzip"]:
        (csrc / name).write_bytes((_build.CSRC / name).read_bytes())
    (csrc / "pgzip.cpp").write_text(
        (_build.CSRC / "pgzip.cpp").read_text()
        + "\nint broken( { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError) as err:
        _build.build_all(["pgzip"])
    assert "pgzip.cpp" in str(err.value) and "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_gxx_means_no_native_library(tmp_path, monkeypatch):
    """Only a host without g++ has no native library: it warns once and
    every layer takes the Python sink and the stdlib codec."""
    warned = []
    monkeypatch.setattr(_build, "gxx", lambda: None)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_warned", False)
    monkeypatch.setattr(native.log, "warning",
                        lambda msg, *a, **k: warned.append(msg % a))
    assert not native.pgzip_available()
    assert not native.layersink_available()
    assert len(warned) == 1 and "no g++ on PATH" in warned[0]
    assert tario.resolve_backend("auto") == "zlib"
    with open(tmp_path / "out.gz", "wb") as out:
        assert hasher.CPUHasher().open_layer(out, "zlib-6").route == \
            "python"
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        native.LayerSinkHandle(1, "zlib", 6)
    data = stream(3 * tario.PGZIP_BLOCK + 11, seed=8)
    assert tario._deflate_blocks(data, 6, tario.PGZIP_BLOCK, True) == \
        tario._py_deflate_blocks(data, 6, tario.PGZIP_BLOCK, True)


def test_libraries_are_keyed_by_their_sources():
    assert native.zlib_version().startswith("1.")
    path = _build.library_path("layersink")
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path != _build.library_path("pgzip")
    assert os.path.basename(path).startswith("liblayersink-")
