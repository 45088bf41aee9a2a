"""The port's SnapshotHasher on the CPU held bit-exact against the JAX
package's SnapshotHasher(use_pallas=False) forward on the same numpy
inputs, at the shape of the reference's compile gate."""

import dataclasses

import numpy as np
import pytest
import torch

from makisu_tpu.models import SnapshotHasher as RefHasher
from makisu_tpu.ops import gear as jgear
from makisu_tpu.ops import sha256 as jsha
from makisu_tpu_torch.models import SnapshotHasher
from makisu_tpu_torch.ops import gear, sha256

TINY = dict(batch=2, block_bytes=64 * 1024, lanes=256, lane_cap=2048)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, size=(TINY["batch"], TINY["block_bytes"]),
                          dtype=np.uint8)
    lanes = rng.integers(0, 256, size=(TINY["lanes"], TINY["lane_cap"]),
                         dtype=np.uint8)
    lengths = rng.integers(0, TINY["lane_cap"] - 8,
                           size=TINY["lanes"]).astype(np.int32)
    lengths[:4] = [0, 55, 64, TINY["lane_cap"] - 9]
    return blocks, lanes, lengths


@pytest.mark.parametrize("through_module", [True, False])
def test_forward_matches_reference(through_module):
    """The module, and the plain functions the smoke run holds it
    against on the card, both equal the reference."""
    blocks, lanes, lengths = _inputs()
    ref = RefHasher(**TINY, use_pallas=False)
    want_bitmap, want_digests = ref.jit_forward()(blocks, lanes, lengths)
    b, ln, n = (torch.from_numpy(a) for a in (blocks, lanes, lengths))
    if through_module:
        bitmap, digests = SnapshotHasher(**TINY, device="cpu")(b, ln, n)
    else:
        bitmap = gear.gear_bitmap(b, gear.DEFAULT_AVG_BITS)
        digests = sha256.sha256_lanes(ln, n)
    np.testing.assert_array_equal(bitmap.numpy(), np.asarray(want_bitmap))
    np.testing.assert_array_equal(digests.numpy(), np.asarray(want_digests))


def test_from_reference_carries_fields_and_checks_tables():
    ref = RefHasher(**TINY, use_pallas=False)
    tables = {"gear_table": jgear.gear_table(), "sha256_K": jsha._K,
              "sha256_H0": jsha._H0}
    model = SnapshotHasher.from_reference(dataclasses.asdict(ref), tables,
                                          device="cpu")
    for key, value in TINY.items():
        assert getattr(model, key) == value
    assert model.avg_bits == ref.avg_bits
    assert not hasattr(model, "use_pallas")  # one route per device
    auto = SnapshotHasher.from_reference(
        dataclasses.asdict(RefHasher(**TINY)), tables, device="cpu")
    assert auto.lanes == model.lanes
    blocks, lanes, lengths = _inputs(1)
    got = model(*(torch.from_numpy(a) for a in (blocks, lanes, lengths)))
    want = ref.jit_forward()(blocks, lanes, lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bad = dict(tables, sha256_K=jsha._K ^ np.uint32(1))
    with pytest.raises(ValueError, match="sha256_K"):
        SnapshotHasher.from_reference(dataclasses.asdict(ref), bad,
                                      device="cpu")
    with pytest.raises(ValueError, match="gear_table"):
        SnapshotHasher.from_reference(dataclasses.asdict(ref), {},
                                      device="cpu")


def test_defaults_match_reference():
    ref = RefHasher()
    model = SnapshotHasher(device="cpu")
    for field in ("avg_bits", "block_bytes", "batch", "lanes", "lane_cap"):
        assert getattr(model, field) == getattr(ref, field)


def test_example_inputs_shapes():
    model = SnapshotHasher(**TINY, device="cpu")
    blocks, lanes, lengths = model.example_inputs()
    assert blocks.shape == (2, 64 * 1024) and blocks.dtype == torch.uint8
    assert lanes.shape == (256, 2048) and lengths.dtype == torch.int32
    assert int(lengths.max()) <= 2048 - 9


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SnapshotHasher()
