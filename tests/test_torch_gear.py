"""The port's Gear bitmap (plain version, and the kernel wrapper's CPU
route) held bit-exact against the JAX package on the same numpy inputs:
the XLA route (zero-G-value history), the interpret-mode Pallas kernels
``_gear_kernel`` (zero-byte head) and ``_gear_kernel2`` (zero history)."""

import numpy as np
import pytest
import torch

from makisu_tpu.ops import gear as jgear
from makisu_tpu.ops import gear_pallas
from makisu_tpu_torch.ops import gear, gear_cuda


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def test_gear_table_matches_reference():
    np.testing.assert_array_equal(gear.gear_table(), jgear.gear_table())
    g = gear._gear_value(torch.arange(256, dtype=torch.int64)
                         .to(torch.uint8)).numpy()
    np.testing.assert_array_equal(g.astype(np.uint32), jgear.gear_table())


@pytest.mark.parametrize("n", [32, 1024, 64 * 1024, 2 * 64 * 1024 + 96])
def test_plain_bitmap_matches_xla_route(n):
    """Sizes cover the reference's flat path and (2 x 64 KiB + 96) its
    blocked-scan branch with a leading remainder."""
    data = _bytes(n, n)
    got = gear.gear_bitmap(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgear.gear_bitmap(data)))


def test_plain_bitmap_batch_matches_xla_route():
    data = _bytes((3, 4096), 5)
    got = gear.gear_bitmap(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgear.gear_bitmap(data)))


@pytest.mark.parametrize("avg_bits", [1, 4, 13])
def test_plain_hash_matches_sequential_reference(avg_bits):
    data = _bytes(512, avg_bits)
    h = gear.gear_hash(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(h.astype(np.uint32),
                                  gear.gear_hash_ref(data.tobytes()))
    got = gear.gear_bitmap(torch.from_numpy(data), avg_bits).numpy()
    want = np.asarray(jgear.gear_bitmap(data, avg_bits))
    np.testing.assert_array_equal(got, want)


def test_bitmap_with_halo_matches_reference():
    data = _bytes((2, 2048), 9)
    halo = np.random.default_rng(10).integers(
        0, 2**32, size=(2, gear.WINDOW - 1), dtype=np.uint64).astype(np.uint32)
    got = gear.gear_bitmap_with_halo(
        torch.from_numpy(data), torch.from_numpy(halo.astype(np.int64))).numpy()
    want = np.asarray(jgear.gear_bitmap_with_halo(data, halo))
    np.testing.assert_array_equal(got, want)


def test_zero_bytes_head_matches_pallas_kernel_everywhere():
    """head="zero_bytes" reproduces _gear_kernel (via gear_bitmap_batch,
    interpret mode) at every position, the head included."""
    B, n = 3, 2 * gear_pallas.ROW_TILE * gear_pallas.ROW
    blocks = _bytes((B, n), 21)
    want = np.asarray(gear_pallas.gear_bitmap_batch(blocks, interpret=True))
    got = gear_cuda.gear_bitmap(torch.from_numpy(blocks),
                                head="zero_bytes").numpy()
    np.testing.assert_array_equal(got, want)
    # ...and differs from zero history only below the window.
    zh = gear.gear_bitmap(torch.from_numpy(blocks)).numpy()
    for b in range(B):
        diff = np.flatnonzero(gear.unpack_bits_np(got[b], n)
                              != gear.unpack_bits_np(zh[b], n))
        assert (diff < gear.WINDOW).all()


@pytest.mark.parametrize("n_live", [1, 100, 33000])
def test_zero_history_head_matches_pallas_kernel2(n_live):
    """head="zero_history" reproduces _gear_kernel2 (gear_bitmap_flat2,
    interpret mode), whose carry crosses grid steps for n_live > 32 KiB."""
    tile = gear_pallas.V2_TILE
    buf = np.zeros(-(-n_live // tile) * tile, dtype=np.uint8)
    buf[:n_live] = _bytes(n_live, n_live)
    want = np.asarray(gear_pallas.gear_bitmap_flat2(buf, interpret=True))
    got = gear_cuda.gear_bitmap(torch.from_numpy(buf),
                                head="zero_history").numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_cpu_tensor_takes_plain_version_without_launch():
    data = torch.from_numpy(_bytes((2, 1024), 3))
    before = gear_cuda.launches
    for head in gear.HEADS:
        got = gear_cuda.gear_bitmap(data, 7, head)
        assert got.dtype == torch.uint32 and got.shape == (2, 32)
        assert torch.equal(got, gear.gear_bitmap(data, 7, head))
    assert gear_cuda.launches == before


@pytest.mark.parametrize("bad", [
    torch.zeros(33, dtype=torch.uint8),            # not a multiple of 32
    torch.zeros(64, dtype=torch.int32),            # wrong dtype
    torch.zeros((2, 2, 32), dtype=torch.uint8),    # wrong rank
])
def test_wrapper_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        gear_cuda.gear_bitmap(bad)


def test_wrapper_rejects_unknown_head():
    with pytest.raises(ValueError):
        gear_cuda.gear_bitmap(torch.zeros(32, dtype=torch.uint8),
                              head="zero")


def test_candidates_match_unpacked_bitmap():
    words = np.random.default_rng(4).integers(
        0, 2**32, size=97, dtype=np.uint64).astype(np.uint32)
    words[::3] = 0
    bits = gear.unpack_bits_np(words, 97 * 32)
    for lo, hi in ((0, 97 * 32), (128, 97 * 32 - 5), (40, 41), (64, 64)):
        want = np.flatnonzero(bits[:hi])
        np.testing.assert_array_equal(gear.candidates_np(words, lo, hi),
                                      want[want >= lo])


@pytest.mark.parametrize("n", [0, 5000, 300_001])
def test_select_boundaries_matches_reference(n):
    rng = np.random.default_rng(n)
    cands = np.sort(rng.choice(max(n, 1), size=min(n, 40), replace=False))
    np.testing.assert_array_equal(
        gear.select_boundaries_np(cands, n),
        jgear.select_boundaries_np(cands, n))
