"""The layer-commit hashing seam on the card."""

from makisu_tpu_torch.chunker.hasher import (
    ChunkFingerprint,
    GPUHasher,
    LayerCommit,
    LayerSink,
    get_hasher,
)

__all__ = ["ChunkFingerprint", "GPUHasher", "LayerCommit", "LayerSink",
           "get_hasher"]
