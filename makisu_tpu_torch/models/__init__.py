"""The snapshot-hash step as a torch module."""

from makisu_tpu_torch.models.snapshot_hasher import SnapshotHasher

__all__ = ["SnapshotHasher"]
