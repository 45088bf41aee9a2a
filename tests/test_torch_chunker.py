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


def test_finish_releases_the_ring_and_blocks(xla_reference):
    """A spent session keeps no ring or host block alive (a resident
    process commits layer after layer); its chunks are the reference's."""
    data = rand_bytes(200_000, 41)
    session = ChunkSession(block=32 * 1024, device="cpu")
    got = run(session, data)
    assert session._ring is None and session._free == []
    assert session._cur is None and not session._inflight
    assert got == run(RefSession(block=32 * 1024), data)


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


def test_observer_error_drops_observer_and_keeps_chunks(xla_reference):
    """An observer that raises is called no more, and the session's
    chunks equal the reference session's all the same."""
    calls = []

    def observer(hex_digest):
        calls.append(hex_digest)
        if len(calls) == 2:
            raise RuntimeError("cache plane down")

    kw = dict(block=32 * 1024, avg_bits=10, min_size=512, max_size=4096)
    data = rand_bytes(40_000, 6)
    token = cdc.set_chunk_observer(observer)
    try:
        session = ChunkSession(device="cpu", **kw)
    finally:
        cdc.reset_chunk_observer(token)
    got = run(session, data)
    assert len(got) > 2 and len(calls) == 2
    assert calls == [d.hex() for _, _, d in got[:2]]
    assert got == run(RefSession(**kw), data)


SMALL = dict(avg_bits=10, min_size=512, max_size=4096)


def _wrap_stream(kind, seed, max_size):
    if kind == "random":
        return rand_bytes(400_000, seed)
    # Zero runs longer than max_size straddle the wraps: forced max-size
    # cuts whose bytes lie partly in the guard.
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < 300_000:
        parts.append(rand_bytes(int(rng.integers(1, 40_000)),
                                int(rng.integers(1 << 30))))
        parts.append(bytes(int(rng.integers(max_size + 5_000,
                                            2 * max_size + 40_000))))
    return b"".join(parts)


@pytest.mark.parametrize("ring,kind,step,kw", [
    (3, "random", 50_001, {}),
    (3, "zeros", 7_777, {}),
    (4, "zeros", 65_537, SMALL)], ids=["random", "zeros", "zeros-small"])
def test_ring_wraps_match_reference(xla_reference, monkeypatch, ring, kind,
                                    step, kw):
    """A ring of a few 32 KiB slots wraps several times over the stream;
    chunks that straddle a wrap hash out of the guard."""
    monkeypatch.setattr(ChunkSession, "RING_BLOCKS", ring)
    max_size = kw.get("max_size", gear.DEFAULT_MAX_SIZE)
    data = _wrap_stream(kind, ring, max_size)
    session = ChunkSession(block=32 * 1024, device="cpu", **kw)
    got = run(session, data, step)
    passes = -(-len(data) // (ring * 32 * 1024))
    assert session.span_launches == passes >= 3
    assert got == run(RefSession(block=32 * 1024, **kw), data)
    if kind == "zeros":
        assert sum(n == max_size for _, n, _ in got) >= 3
    for off, n, digest in got:
        assert digest == hashlib.sha256(data[off:off + n]).digest()


def test_ring_smaller_than_guard_rejected(monkeypatch):
    monkeypatch.setattr(ChunkSession, "RING_BLOCKS", 3)
    with pytest.raises(ValueError, match="ring"):
        ChunkSession(block=16 * 1024, device="cpu")
    monkeypatch.setattr(ChunkSession, "RING_BLOCKS", 2)
    with pytest.raises(ValueError, match="ring"):
        ChunkSession(block=64 * 1024, device="cpu")


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


class _NeverDone:
    """A stand-in CUDA event whose work never completes."""

    def query(self):
        return False

    def synchronize(self):
        raise AssertionError("an unbounded wait")


@pytest.mark.parametrize("where", ["update", "finish"])
def test_a_raised_session_holds_no_ring(monkeypatch, where):
    """A session whose bitmap readback times out (a stand-in event that
    never fires) raises TimeoutError naming the wait, and drops its ring,
    its pinned blocks and its pending launches at once, as ``finish``
    does on success."""
    monkeypatch.setenv("MAKISU_TPU_SYNC_TIMEOUT", "0.1")

    class HangingBlock(cdc._HostBlock):
        def __init__(self, *a):
            super().__init__(*a)
            self.done = _NeverDone()

    monkeypatch.setattr(cdc, "_HostBlock", HangingBlock)
    # Not the process's first G1 launch, which waits for its bitmap.
    monkeypatch.setattr(cdc.backend, "_compiled", {"gear"})
    s = ChunkSession(block=32 * 1024, device="cpu")
    # Two blocks stay in flight (PIPELINE_DEPTH); a third waits on one.
    data = rand_bytes((3 if where == "update" else 2) * 32 * 1024, 41)
    if where == "finish":
        s.update(data)
        assert s._ring is not None and len(s._inflight) == 2
    with pytest.raises(TimeoutError, match="gear bitmap readback"):
        s.update(data) if where == "update" else s.finish()
    assert s._ring is None and s._cur is None
    assert not s._free and not s._inflight and not s._pending
