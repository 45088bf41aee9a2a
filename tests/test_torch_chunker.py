"""The port's ChunkSession on the CPU (the kernels' plain versions) held
against the JAX package's ChunkSession on its XLA route: identical chunk
lists (offset, length, digest) for the same bytes."""

import hashlib

import numpy as np
import pytest
import torch

from makisu_tpu.chunker.cdc import ChunkSession as RefSession
from makisu_tpu_torch.chunker import cdc
from makisu_tpu_torch.chunker.cdc import ChunkSession
from makisu_tpu_torch.ops import gear


def rand_bytes(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def run(session, data, step=50_001):
    for i in range(0, len(data), step):
        session.update(data[i:i + step])
    return [(c.offset, c.length, c.digest) for c in session.finish()]


@pytest.fixture
def xla_reference(monkeypatch):
    """The reference session on its device (XLA) route, not the native
    C++ route."""
    monkeypatch.setenv("MAKISU_TPU_CHUNK_NATIVE", "0")


@pytest.mark.parametrize("seed,size", [(11, 0), (12, 1), (13, 5_000),
                                       (14, 131_072), (15, 300_001),
                                       (16, 64 * 1024)])
def test_chunks_match_reference(xla_reference, seed, size):
    data = rand_bytes(size, seed)
    got = run(ChunkSession(block=64 * 1024, device="cpu"), data)
    assert got == run(RefSession(block=64 * 1024), data)
    # Tiling, digests and the whole-stream policy oracle.
    assert sum(n for _, n, _ in got) == size
    for off, n, digest in got:
        assert digest == hashlib.sha256(data[off:off + n]).digest()
    buf = np.frombuffer(data + bytes((-size) % 32), dtype=np.uint8)
    words = gear.gear_bitmap(torch.from_numpy(buf.copy())).numpy()
    oracle = gear.select_boundaries_np(gear.candidates_np(words, 0, size),
                                       size)
    assert [off + n for off, n, _ in got] == [int(e) for e in oracle if e]


def test_block_size_does_not_change_chunks(xla_reference):
    """32 KiB and 128 KiB blocks (halo carried across blocks) cut the
    same chunks, equal to the reference's."""
    data = rand_bytes(200_000, 21)
    small = run(ChunkSession(block=32 * 1024, device="cpu"), data, 7_777)
    large = run(ChunkSession(block=128 * 1024, device="cpu"), data, 65_536)
    assert small == large == run(RefSession(block=128 * 1024), data)


def test_zero_bytes_force_max_size_cuts(xla_reference):
    data = bytes(300_000)
    got = run(ChunkSession(block=64 * 1024, device="cpu"), data)
    assert got == run(RefSession(block=64 * 1024), data)
    assert [n for _, n, _ in got] == [65536] * 4 + [300_000 - 4 * 65536]


def test_small_geometry_matches_reference(xla_reference):
    data = rand_bytes(150_000, 31)
    kw = dict(avg_bits=10, min_size=512, max_size=4096)
    got = run(ChunkSession(block=32 * 1024, device="cpu", **kw), data)
    assert got == run(RefSession(block=32 * 1024, **kw), data)
    assert len(got) > 30


def test_empty_stream():
    assert ChunkSession(device="cpu").finish() == []


def test_observer_sees_every_fingerprint():
    seen = []
    token = cdc.set_chunk_observer(seen.append)
    try:
        session = ChunkSession(block=32 * 1024, device="cpu",
                               avg_bits=10, min_size=512, max_size=4096)
    finally:
        cdc.reset_chunk_observer(token)
    chunks = run(session, rand_bytes(40_000, 5))
    assert seen == [d.hex() for _, _, d in chunks]


def test_default_device_without_cuda_raises(monkeypatch):
    """No silent CPU route: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ChunkSession()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ChunkSession(device="cuda")


@pytest.mark.parametrize("kw", [dict(block=100), dict(block=0),
                                dict(min_size=0),
                                dict(min_size=4096, max_size=2048),
                                dict(max_size=128 * 1024)])
def test_bad_geometry_rejected(kw):
    with pytest.raises(ValueError):
        ChunkSession(device="cpu", **kw)
