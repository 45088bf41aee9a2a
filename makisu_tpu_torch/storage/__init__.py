"""Local image storage: content-addressed layer store, manifest store,
per-build sandbox, and the content store that governs them.

Copy of ``makisu_tpu/storage/`` with the same on-disk layout, so one
storage dir serves both builders: the CAS, the manifest and image
stores, and ``contentstore`` (pins, byte budgets, eviction and the
pack/remote tiers).
"""

from makisu_tpu_torch.storage.cas import CASStore
from makisu_tpu_torch.storage.contentstore import (ContentStore,
                                                   EvictionPolicy, PinBoard,
                                                   store_for)
from makisu_tpu_torch.storage.image_store import ImageStore
from makisu_tpu_torch.storage.manifests import ManifestStore

__all__ = ["CASStore", "ContentStore", "EvictionPolicy", "ImageStore",
           "ManifestStore", "PinBoard", "store_for"]
