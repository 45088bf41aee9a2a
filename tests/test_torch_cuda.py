"""The CUDA kernels against their plain versions on the card. These need
an NVIDIA card and nvcc, and skip without CUDA; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a machine with
the card need not have; this file imports nothing of JAX.)
"""

import hashlib

import numpy as np
import pytest
import torch

from makisu_tpu_torch.chunker.cdc import ChunkSession
from makisu_tpu_torch.ops import gear, gear_cuda, sha256, sha256_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(32,), (8192,), (3, 65536 + 96)])
@pytest.mark.parametrize("head", gear.HEADS)
def test_gear_kernel_matches_plain(dev, shape, head):
    data = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=shape, dtype=np.uint8)).to(dev)
    before = gear_cuda.launches
    for avg_bits in (1, 4, 13):
        got = gear_cuda.gear_bitmap(data, avg_bits, head)
        want = gear.gear_bitmap(data, avg_bits, head)
        assert torch.equal(got.cpu(), want.cpu())
    assert gear_cuda.launches == before + 3


@pytest.mark.parametrize("lanes,cap", [(64, 1024), (300, 16384)])
def test_sha256_kernel_matches_plain_and_hashlib(dev, lanes, cap):
    data, lengths = sha256_cuda.probe_inputs(lanes, cap, seed=3)
    d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
    got = sha256_cuda.sha256_lanes(d, ln).cpu().numpy()
    np.testing.assert_array_equal(got, sha256.sha256_lanes(d, ln).cpu()
                                  .numpy())
    np.testing.assert_array_equal(got, sha256_cuda.hashlib_words(data,
                                                                 lengths))


def test_sha256_kernel_flags_out_of_range_length(dev):
    data, lengths = sha256_cuda.probe_inputs(64, 1024, seed=4)
    sha256_cuda.check_lengths(dev)
    lengths[5] = 1024 - 8
    got = sha256_cuda.sha256_lanes(torch.from_numpy(data).to(dev),
                                   torch.from_numpy(lengths).to(dev))
    with pytest.raises(ValueError, match="lane length"):
        sha256_cuda.check_lengths(dev)
    sha256_cuda.check_lengths(dev)  # the check clears the flag
    empty = np.frombuffer(hashlib.sha256(b"").digest(), dtype=">u4")
    np.testing.assert_array_equal(got.cpu().numpy()[5], empty)


@pytest.mark.parametrize("offset_dtype", [np.int64, np.int32])
def test_sha256_spans_kernel_matches_plain_and_hashlib(dev, offset_dtype):
    """The parity probe's spans: every offset mod 64, the padding edges,
    and 64 KiB spans of each alignment ending at the buffer's end."""
    buf, offsets, lengths = sha256_cuda.probe_spans()
    offsets = offsets.astype(offset_dtype)
    order = np.argsort(-lengths, kind="stable")  # longest first
    b = torch.from_numpy(buf).to(dev)
    o = torch.from_numpy(offsets[order]).to(dev)
    ln = torch.from_numpy(lengths[order]).to(dev)
    before = sha256_cuda.launches
    got = sha256_cuda.sha256_spans(b, o, ln).cpu().numpy()
    assert sha256_cuda.launches == before + 1
    sha256_cuda.check_lengths(dev)
    np.testing.assert_array_equal(got, sha256.sha256_spans(b, o, ln).cpu()
                                  .numpy())
    np.testing.assert_array_equal(got, sha256_cuda.hashlib_span_words(
        buf, offsets[order], lengths[order]))


def test_sha256_spans_kernel_flags_span_outside_buffer(dev):
    buf = torch.zeros(256, dtype=torch.uint8, device=dev)
    sha256_cuda.check_lengths(dev)
    got = sha256_cuda.sha256_spans(
        buf, torch.tensor([0, 250], device=dev),
        torch.tensor([3, 7], dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="outside its buffer"):
        sha256_cuda.check_lengths(dev)
    empty = np.frombuffer(hashlib.sha256(b"").digest(), dtype=">u4")
    np.testing.assert_array_equal(got.cpu().numpy()[1], empty)


def test_ring_session_on_card_matches_cpu_across_wraps(dev, monkeypatch):
    monkeypatch.setattr(ChunkSession, "RING_BLOCKS", 3)
    rng = np.random.default_rng(6)
    data = b"".join(
        rng.integers(0, 256, size=int(rng.integers(1, 200_000)),
                     dtype=np.uint8).tobytes() + bytes(100_000)
        for _ in range(6))

    def run(device):
        s = ChunkSession(block=32 * 1024, device=device)
        for i in range(0, len(data), 9_999):
            s.update(data[i:i + 9_999])
        return s.finish(), s.span_launches

    sha256_cuda.parity_probe(dev)  # its launch is not the session's
    before = sha256_cuda.launches
    got, launches = run(dev)
    assert sha256_cuda.launches == before + launches
    assert launches == -(-len(data) // (3 * 32 * 1024))
    assert (got, launches) == run("cpu")
    mv = memoryview(data)
    assert all(hashlib.sha256(mv[c.offset:c.offset + c.length]).digest()
               == c.digest for c in got)


def test_session_on_card_matches_cpu(dev):
    data = np.random.default_rng(5).integers(
        0, 256, size=3_000_000, dtype=np.uint8).tobytes()

    def run(device):
        s = ChunkSession(block=1 << 20, device=device)
        for i in range(0, len(data), 65536):
            s.update(data[i:i + 65536])
        return s.finish()

    before = gear_cuda.launches
    assert run(dev) == run("cpu")
    assert gear_cuda.launches == before + 3
