"""The layer-commit hashing seam on the card."""

from makisu_tpu_torch.chunker.hasher import (
    ChunkFingerprint,
    CPUHasher,
    GPUHasher,
    Hasher,
    LayerCommit,
    LayerSink,
    get_hasher,
)

__all__ = ["CPUHasher", "ChunkFingerprint", "GPUHasher", "Hasher",
           "LayerCommit", "LayerSink", "get_hasher"]
