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
