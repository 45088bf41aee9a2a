"""SnapshotHasher: the hash step as one module on the two kernels.

One ``forward`` consumes a batch of layer-stream blocks and a batch of
chunk lanes and produces (candidate-boundary bitmaps, chunk digests).
Counterpart of ``makisu_tpu/models/snapshot_hasher.py``; the gear route
is the zero-history bitmap, bit-identical to the reference's
``use_pallas=False`` forward. The module has one route per device: the
CUDA kernels for tensors on the card, their plain versions for tensors
on the CPU. ``sharded_step`` is the same step over a (data, seq) mesh of
``torch.distributed`` ranks (``parallel/``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from makisu_tpu_torch.ops import backend, gear, gear_cuda, sha256, sha256_cuda


class SnapshotHasher(nn.Module):
    """Chunking geometry + batch shapes; no learned parameters."""

    def __init__(self, avg_bits: int = gear.DEFAULT_AVG_BITS,
                 block_bytes: int = 1 << 20, batch: int = 8,
                 lanes: int = 1024, lane_cap: int = 16 * 1024,
                 device=None) -> None:
        super().__init__()
        if block_bytes % 32 or lane_cap % 64:
            raise ValueError("block_bytes must be a multiple of 32 and "
                             "lane_cap a multiple of 64")
        self.avg_bits = avg_bits
        self.block_bytes = block_bytes
        self.batch = batch
        self.lanes = lanes
        self.lane_cap = lane_cap
        self.device = backend.resolve_device(device)
        if self.device.type == "cuda":
            # The device plane comes up, bounded, before the first launch.
            backend.require_ready(self.device)

    @classmethod
    def from_reference(cls, fields: dict, tables: dict[str, np.ndarray],
                       device=None) -> "SnapshotHasher":
        """Build from the reference model's dataclass fields and its
        constants: ``tables`` holds ``gear_table``, ``sha256_K`` and
        ``sha256_H0`` as numpy arrays, which must equal this package's
        own (they are cache identity). The reference's ``use_pallas``
        chose between two routes on its accelerator; it is accepted and
        ignored, since the port runs the kernels on the card and their
        plain versions on the CPU whatever it says."""
        ours = {"gear_table": gear.gear_table(), "sha256_K": sha256._K,
                "sha256_H0": sha256._H0}
        for name, want in ours.items():
            got = tables.get(name)
            if got is None or not np.array_equal(
                    np.asarray(got, dtype=np.uint32), want):
                raise ValueError(f"reference table {name} differs from "
                                 "this package's")
        known = {"avg_bits", "block_bytes", "batch", "lanes", "lane_cap",
                 "use_pallas"}
        extra = set(fields) - known
        if extra:
            raise ValueError(f"unknown reference fields {sorted(extra)}")
        kw = {k: v for k, v in fields.items() if k != "use_pallas"}
        return cls(**kw, device=device)

    def example_inputs(self, seed: int = 0):
        """Seeded random (blocks, lanes, lengths) on the module's device."""
        rng = np.random.default_rng(seed)
        blocks = rng.integers(0, 256, size=(self.batch, self.block_bytes),
                              dtype=np.uint8)
        lanes = rng.integers(0, 256, size=(self.lanes, self.lane_cap),
                             dtype=np.uint8)
        lengths = rng.integers(0, self.lane_cap - 8,
                               size=self.lanes).astype(np.int32)
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (blocks, lanes, lengths))

    def forward(self, blocks: torch.Tensor, lanes: torch.Tensor,
                lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 blocks [B, N] (N % 32 == 0), uint8 lanes [L, CAP], int32
        lengths [L] in [0, CAP - 9] -> (uint32 bitmap [B, N/32], uint32
        digests [L, 8]). On the card, ``sha256_cuda.check_lengths``
        reports an out-of-range length once the caller has synchronised."""
        return (gear_cuda.gear_bitmap(blocks, self.avg_bits),
                sha256_cuda.sha256_lanes(lanes, lengths))

    def sharded_step(self, mesh):
        """The multi-device step over a (data, seq) mesh: a callable over
        this rank's local shards (``parallel.snapshot_hash_step``)."""
        from makisu_tpu_torch.parallel.pipeline import snapshot_hash_step
        return snapshot_hash_step(mesh, self.avg_bits)
