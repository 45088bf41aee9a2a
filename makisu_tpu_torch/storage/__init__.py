"""Local image storage: content-addressed layer store, manifest store,
per-build sandbox.

Copy of ``makisu_tpu/storage/`` with the same on-disk layout, so one
storage dir serves both builders. The content store (budgets, tiers) is
not part of the port yet.
"""

from makisu_tpu_torch.storage.cas import CASStore
from makisu_tpu_torch.storage.image_store import ImageStore
from makisu_tpu_torch.storage.manifests import ManifestStore

__all__ = ["CASStore", "ImageStore", "ManifestStore"]
