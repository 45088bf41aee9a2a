"""The port's pgzip writer and backend ids against the JAX package's.

``makisu_tpu_torch.tario`` and ``makisu_tpu.tario`` compress the same
seeded bytes: ``BlockGzipWriter`` and the block codecs (the stdlib one,
``_py_deflate_blocks``, and each package's native ``deflate_blocks``)
give equal bytes at every level, input size, write size and lane count
tested, with both packages pinned to the same codec; the backend-id
parsers accept and refuse the same ids, and ``--gzip-backend auto``
resolves alike with the native library present and absent.
"""

import gzip
import io

import numpy as np
import pytest

from makisu_tpu import native as ref_native
from makisu_tpu import tario as ref_tario
from makisu_tpu_torch import native, tario
from makisu_tpu_torch.utils import concurrency

BLOCK = tario.PGZIP_BLOCK
SIZES = [0, 1, BLOCK - 1, BLOCK, BLOCK + 1, 8 * BLOCK + 7]


def payload(n: int, seed: int = 0) -> bytes:
    """Half text-like, half random: both deflate paths get exercised."""
    rng = np.random.default_rng(seed)
    words = rng.integers(97, 123, size=n, dtype=np.uint8)
    words[rng.random(n) < 0.15] = 32
    noise = rng.integers(0, 256, size=n, dtype=np.uint8)
    return bytes(np.where(np.arange(n) % 4096 < 2048, words, noise))


def write_all(writer, data: bytes, step: int | None) -> None:
    if step is None:
        writer.write(data)
    else:
        for i in range(0, len(data), step):
            writer.write(data[i:i + step])
    writer.close()


@pytest.fixture
def reference_codec(monkeypatch):
    """Both packages on the stdlib codec. The native codecs are held to
    each other in the ``native_codec`` cases: at level 0 the stdlib and
    the native codec frame stored blocks differently (ROADMAP §C)."""
    monkeypatch.setattr(ref_native, "pgz_blocks_available", lambda: False)
    monkeypatch.setattr(native, "pgzip_available", lambda: False)


@pytest.fixture
def native_codec():
    """Both packages on their native codec (built from their own
    sources)."""
    assert native.pgzip_available() and ref_native.pgz_blocks_available()


@pytest.mark.parametrize("step", [None, 10 * 1024], ids=["one", "10KiB"])
@pytest.mark.parametrize("size", SIZES)
def test_block_writer_matches_reference_at_every_size(reference_codec,
                                                      size, step):
    data = payload(size, seed=size)
    got, want = io.BytesIO(), io.BytesIO()
    write_all(tario.BlockGzipWriter(got, level=6, workers=3), data, step)
    write_all(ref_tario.BlockGzipWriter(want, level=6, workers=3), data,
              step)
    assert got.getvalue() == want.getvalue()
    assert gzip.decompress(got.getvalue()) == data


@pytest.mark.parametrize("workers", [1, 3, 8])
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_block_writer_matches_reference_at_every_level(reference_codec,
                                                       level, workers):
    data = payload(8 * BLOCK + 7, seed=level)
    got, want = io.BytesIO(), io.BytesIO()
    write_all(tario.BlockGzipWriter(got, level=level, workers=workers),
              data, 16 * 1024)
    write_all(ref_tario.BlockGzipWriter(want, level=level, workers=1),
              data, None)
    assert got.getvalue() == want.getvalue()
    assert gzip.decompress(got.getvalue()) == data


@pytest.mark.parametrize("workers", [1, 3, 8])
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_block_writer_matches_reference_with_native_codec(native_codec,
                                                          level, workers):
    data = payload(8 * BLOCK + 7, seed=level)
    got, want = io.BytesIO(), io.BytesIO()
    write_all(tario.BlockGzipWriter(got, level=level, workers=workers),
              data, 16 * 1024)
    write_all(ref_tario.BlockGzipWriter(want, level=level, workers=1),
              data, None)
    assert got.getvalue() == want.getvalue()
    assert gzip.decompress(got.getvalue()) == data


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_native_deflate_blocks_match_reference(native_codec, level, last):
    data = payload(3 * BLOCK + (17 if last else 0), seed=5)
    got = native.deflate_blocks(data, level, BLOCK, last)
    assert got == ref_native.deflate_blocks(data, level, BLOCK, last)
    if level:
        # The two codecs of one package agree above level 0.
        assert got == tario._py_deflate_blocks(data, level, BLOCK, last)


def test_level0_codecs_differ_in_both_packages(native_codec):
    """The recorded level-0 divergence (ROADMAP §C), smallest input: at
    32,768 bytes the native codec writes one stored block, the stdlib
    codec two. Both packages share it, so each host's pgzip-0 blob is
    the same in both packages."""
    data = bytes(range(256)) * 128
    for nat, py in ((native, tario), (ref_native, ref_tario)):
        assert len(nat.deflate_blocks(data, 0, BLOCK, True)) == 32773
        assert len(py._py_deflate_blocks(data, 0, BLOCK, True)) == 32778
    short = data[:32767]
    assert native.deflate_blocks(short, 0, BLOCK, True) == \
        tario._py_deflate_blocks(short, 0, BLOCK, True)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_deflate_blocks_match_reference(level, last):
    data = payload(3 * BLOCK + (17 if last else 0), seed=5)
    assert tario._py_deflate_blocks(data, level, BLOCK, last) == \
        ref_tario._py_deflate_blocks(data, level, BLOCK, last)


def test_deflate_blocks_refuse_partial_batches():
    for fn in (tario._py_deflate_blocks, ref_tario._py_deflate_blocks):
        with pytest.raises(ValueError):
            fn(b"x" * (BLOCK + 1), 6, BLOCK, False)
        with pytest.raises(ValueError):
            fn(b"", 6, BLOCK, False)


def test_writer_lanes_default_to_the_context(monkeypatch):
    token = concurrency.set_compress_workers(3)
    try:
        assert concurrency.compress_workers() == 3
        assert tario.BlockGzipWriter(io.BytesIO()).workers == 3
    finally:
        concurrency.reset_compress_workers(token)
    monkeypatch.setenv("MAKISU_TPU_COMPRESS_WORKERS", "2")
    assert concurrency.compress_workers() == 2
    monkeypatch.setenv("MAKISU_TPU_COMPRESS_WORKERS", "bad")
    assert concurrency.compress_workers() == \
        concurrency.default_compress_workers()


def test_gzip_writer_replays_pgzip_ids(reference_codec):
    data = payload(3 * BLOCK + 99, seed=9)
    for backend_id in ("pgzip-6-131072", "pgzip-1-65536", "zlib-6",
                       "zlib-0"):
        got, want = io.BytesIO(), io.BytesIO()
        with tario.gzip_writer(got, backend_id=backend_id) as gz:
            gz.write(data)
        with ref_tario.gzip_writer(want, backend_id=backend_id) as gz:
            gz.write(data)
        assert got.getvalue() == want.getvalue(), backend_id


GOOD_IDS = ["zlib-0", "zlib-6", "zlib-9", "pgzip-6-131072", "pgzip-0-1",
            "pgzip-9-65536"]
BAD_IDS = ["", "zlib", "zlib-", "zlib-x", "zlib-10", "zlib--1",
           "pgzip-6", "pgzip-6-0", "pgzip-6--5", "pgzip-12-131072",
           "lz4-6", "zstd-3", "pgzip-6-abc"]


@pytest.mark.parametrize("backend_id", GOOD_IDS + BAD_IDS + [None])
def test_backend_ids_agree_with_reference(backend_id):
    usable = tario.backend_id_usable(backend_id)
    assert usable == ref_tario.backend_id_usable(backend_id)
    assert usable == (backend_id in GOOD_IDS)
    if usable:
        assert tario.parse_backend_id(backend_id) == \
            ref_tario.parse_backend_id(backend_id)


@pytest.mark.parametrize("level", sorted(tario.COMPRESSION_LEVELS))
@pytest.mark.parametrize("backend", ["zlib", "pgzip", "auto"])
def test_make_backend_id_matches_reference_without_native(monkeypatch,
                                                          backend, level):
    """No native library in either package (a host without g++):
    ``auto`` is zlib in both."""
    monkeypatch.setattr(ref_native, "pgzip_available", lambda: False)
    monkeypatch.setattr(native, "pgzip_available", lambda: False)
    assert tario.make_backend_id(backend, level) == \
        ref_tario.make_backend_id(backend, level)
    assert tario.resolve_backend(backend) == \
        ref_tario.resolve_backend(backend)
    if backend == "auto":
        assert tario.resolve_backend(backend) == "zlib"


@pytest.mark.parametrize("level", sorted(tario.COMPRESSION_LEVELS))
@pytest.mark.parametrize("backend", ["zlib", "pgzip", "auto"])
def test_make_backend_id_matches_reference_with_native(backend, level):
    """Both native libraries load (this host has g++ and zlib): ``auto``
    is pgzip in both, which closes fault C1."""
    assert native.pgzip_available() and ref_native.pgzip_available()
    assert tario.make_backend_id(backend, level) == \
        ref_tario.make_backend_id(backend, level)
    assert tario.resolve_backend(backend) == \
        ref_tario.resolve_backend(backend)
    if backend == "auto":
        assert tario.resolve_backend(backend) == "pgzip"
        assert tario.make_backend_id(backend, "default") == \
            "pgzip-6-131072"


def test_make_backend_id_refuses_unknown_flags():
    with pytest.raises(ValueError):
        tario.make_backend_id("lz4", "default")
    with pytest.raises(ValueError):
        tario.make_backend_id("pgzip", "max")


def test_gzip_reader_reads_gzip_and_plain_streams():
    data = payload(5000)
    blob = io.BytesIO()
    with tario.gzip_writer(blob, backend_id="pgzip-6-131072") as gz:
        gz.write(data)
    blob.seek(0)
    assert tario.gzip_reader(blob).read() == data


def test_concurrent_writers_share_the_pool(reference_codec):
    """More writers than cores on the shared pool, with a short switch
    interval: every stream still comes out byte-identical to the
    reference's, and each writer's busy seconds are its own."""
    import sys
    import threading

    data = [payload(4 * BLOCK + 11 * k, seed=k) for k in range(16)]
    want = []
    for d in data:
        buf = io.BytesIO()
        write_all(ref_tario.BlockGzipWriter(buf, level=6, workers=1), d,
                  None)
        want.append(buf.getvalue())
    got = [None] * len(data)
    busy = [0.0] * len(data)

    def run(k):
        buf = io.BytesIO()
        writer = tario.BlockGzipWriter(buf, level=6, workers=4)
        write_all(writer, data[k], 7777)
        got[k], busy[k] = buf.getvalue(), writer.busy_seconds

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(len(data))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert got == want
    assert all(b > 0 for b in busy)
