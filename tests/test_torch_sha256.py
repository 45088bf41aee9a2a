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
    sha256_cuda.parity_probe(16, 256, torch.device("cpu"))


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
