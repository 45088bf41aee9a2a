"""Layer cache: copy of ``makisu_tpu/cache/``'s KV stores and manager
(reference: lib/cache/ + lib/cache/keyvalue/)."""

from makisu_tpu_torch.cache.kv import FSStore, MemoryStore
from makisu_tpu_torch.cache.manager import (
    EMPTY_ENTRY,
    CacheManager,
    CacheMiss,
    NoopCacheManager,
    decode_entry_full,
    encode_entry,
)

__all__ = [
    "CacheManager", "CacheMiss", "EMPTY_ENTRY", "FSStore", "MemoryStore",
    "NoopCacheManager", "decode_entry_full", "encode_entry",
]
