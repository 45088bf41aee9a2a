"""The port's lane SHA-256 (plain version, and the kernel wrapper's CPU
route) held bit-exact against the JAX package's ``sha256_lanes`` and
hashlib on the same numpy inputs. (The Pallas SHA kernel never runs on
the CPU, so the JAX side is its XLA route.)"""

import hashlib

import numpy as np
import pytest
import torch

from makisu_tpu.ops import sha256 as jsha
from makisu_tpu_torch.ops import sha256, sha256_cuda


def _lanes_from_messages(msgs, cap):
    data = np.zeros((len(msgs), cap), dtype=np.uint8)
    lengths = np.zeros(len(msgs), dtype=np.int32)
    for i, m in enumerate(msgs):
        data[i, :len(m)] = np.frombuffer(m, dtype=np.uint8)
        lengths[i] = len(m)
    return data, lengths


def _port(data, lengths):
    return sha256.sha256_lanes(torch.from_numpy(data),
                               torch.from_numpy(lengths)).numpy()


def test_constants_match_reference():
    np.testing.assert_array_equal(sha256._K, jsha._K)
    np.testing.assert_array_equal(sha256._H0, jsha._H0)


@pytest.mark.parametrize("cap", [64, 256])
def test_boundary_lengths_match_jax_and_hashlib(cap):
    msgs = [(bytes(range(256)) * (n // 256 + 1))[:n]
            for n in range(0, cap - 8)]
    data, lengths = _lanes_from_messages(msgs, cap)
    got = _port(data, lengths)
    np.testing.assert_array_equal(got,
                                  np.asarray(jsha.sha256_lanes(data, lengths)))
    assert sha256.digest_hex(got) == [hashlib.sha256(m).hexdigest()
                                      for m in msgs]


def test_random_ragged_lanes():
    rng = np.random.default_rng(7)
    cap = 1024
    msgs = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, cap - 9, size=64)]
    data, lengths = _lanes_from_messages(msgs, cap)
    # Bytes past each length are arbitrary and must be ignored.
    for i, n in enumerate(lengths):
        data[i, n:] = rng.integers(0, 256, size=cap - n, dtype=np.uint8)
    got = _port(data, lengths)
    np.testing.assert_array_equal(got,
                                  np.asarray(jsha.sha256_lanes(data, lengths)))
    assert sha256.digest_hex(got) == [hashlib.sha256(m).hexdigest()
                                      for m in msgs]


def test_known_vectors():
    data, lengths = _lanes_from_messages([b"abc", b"hello world"], 64)
    out = sha256.digest_hex(_port(data, lengths))
    assert out[0] == (
        "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad")
    assert out[1] == hashlib.sha256(b"hello world").hexdigest()


def test_wrapper_cpu_tensor_takes_plain_version_without_launch():
    data, lengths = sha256_cuda.probe_inputs(16, 256)
    before = sha256_cuda.launches
    got = sha256_cuda.sha256_lanes(torch.from_numpy(data),
                                   torch.from_numpy(lengths))
    assert got.dtype == torch.uint32 and got.shape == (16, 8)
    np.testing.assert_array_equal(got.numpy(),
                                  sha256_cuda.hashlib_words(data, lengths))
    assert sha256_cuda.launches == before


def test_probe_inputs_cover_padding_edges():
    _, lengths = sha256_cuda.probe_inputs(512, 16384)
    assert list(lengths[:8]) == [0, 1, 55, 56, 63, 64, 100, 16384 - 9]
    assert lengths.max() <= 16384 - 9


def test_parity_probe_passes_on_cpu():
    sha256_cuda.parity_probe(torch.device("cpu"))


def test_probe_spans_cover_alignments_and_edges():
    buf, offsets, lengths = sha256_cuda.probe_spans()
    assert set(offsets % 64) == set(range(64))
    assert set(lengths) >= set(sha256_cuda.EDGE_LENGTHS)
    top = offsets + lengths
    assert top.max() == len(buf)
    assert set(offsets[lengths == 65536] % 4) == {0, 1, 2, 3}


SPAN_LENGTHS = (0, 1, 55, 56, 63, 64, 100, 65536)


@pytest.mark.parametrize("length", SPAN_LENGTHS)
def test_spans_match_jax_lanes_and_hashlib(length):
    """Spans at every offset mod 4 and several mod 64, held against the
    JAX package's lane SHA-256 (the spans packed into lanes) and
    hashlib."""
    rng = np.random.default_rng(length)
    leads = (0, 1, 2, 3, 5, 17, 38, 63)
    buf = rng.integers(0, 256, size=64 * len(leads) + length + 64,
                       dtype=np.uint8)
    offsets = np.array([64 * k + lead for k, lead in enumerate(leads)],
                       dtype=np.int64)
    lengths = np.full(len(leads), length, dtype=np.int32)
    got = sha256_cuda.sha256_spans(torch.from_numpy(buf),
                                   torch.from_numpy(offsets),
                                   torch.from_numpy(lengths)).numpy()
    msgs = [buf[o:o + length].tobytes() for o in offsets]
    data, lens = _lanes_from_messages(msgs, -(-(length + 9) // 64) * 64)
    np.testing.assert_array_equal(got,
                                  np.asarray(jsha.sha256_lanes(data, lens)))
    assert sha256.digest_hex(got) == [hashlib.sha256(m).hexdigest()
                                      for m in msgs]


def test_spans_ragged_int32_offsets_in_span_order():
    rng = np.random.default_rng(9)
    buf = rng.integers(0, 256, size=50_000, dtype=np.uint8)
    lengths = rng.integers(0, 9_000, size=40).astype(np.int32)
    offsets = np.array([int(rng.integers(0, len(buf) - n + 1))
                        for n in lengths], dtype=np.int32)
    before = sha256_cuda.launches
    got = sha256_cuda.sha256_spans(torch.from_numpy(buf),
                                   torch.from_numpy(offsets),
                                   torch.from_numpy(lengths))
    assert got.dtype == torch.uint32 and got.shape == (40, 8)
    np.testing.assert_array_equal(
        got.numpy(), sha256_cuda.hashlib_span_words(buf, offsets, lengths))
    assert sha256_cuda.launches == before


@pytest.mark.parametrize("buf,offsets,lengths", [
    (torch.zeros((2, 64), dtype=torch.uint8),
     torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int32)),
    (torch.zeros(64, dtype=torch.int32),
     torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int32)),
    (torch.zeros(64, dtype=torch.uint8),
     torch.zeros(1, dtype=torch.int16), torch.zeros(1, dtype=torch.int32)),
    (torch.zeros(64, dtype=torch.uint8),
     torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)),
    (torch.zeros(64, dtype=torch.uint8),
     torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.int32)),
])
def test_spans_wrapper_rejects_bad_input(buf, offsets, lengths):
    with pytest.raises(ValueError):
        sha256_cuda.sha256_spans(buf, offsets, lengths)


@pytest.mark.parametrize("offset,length", [(-1, 4), (0, 65), (60, 5),
                                           (3, -1)])
def test_span_outside_buffer_raises(offset, length):
    with pytest.raises(ValueError, match="inside the buffer"):
        sha256_cuda.sha256_spans(torch.zeros(64, dtype=torch.uint8),
                                 torch.tensor([0, offset]),
                                 torch.tensor([1, length],
                                              dtype=torch.int32))


@pytest.mark.parametrize("data,lengths", [
    (torch.zeros((2, 100), dtype=torch.uint8),
     torch.zeros(2, dtype=torch.int32)),                 # cap % 64
    (torch.zeros((2, 64), dtype=torch.int32),
     torch.zeros(2, dtype=torch.int32)),                 # data dtype
    (torch.zeros((2, 64), dtype=torch.uint8),
     torch.zeros(2, dtype=torch.int64)),                 # lengths dtype
    (torch.zeros((2, 64), dtype=torch.uint8),
     torch.zeros(3, dtype=torch.int32)),                 # lengths shape
])
def test_wrapper_rejects_bad_input(data, lengths):
    with pytest.raises(ValueError):
        sha256_cuda.sha256_lanes(data, lengths)


@pytest.mark.parametrize("bad", [-1, 256 - 8, 256])
def test_out_of_range_length_raises(bad):
    data, lengths = sha256_cuda.probe_inputs(4, 256)
    lengths[2] = bad
    with pytest.raises(ValueError, match="lengths must lie"):
        sha256_cuda.sha256_lanes(torch.from_numpy(data),
                                 torch.from_numpy(lengths))
    sha256_cuda.check_lengths("cpu")  # the CPU raises at once, never later
