"""Layer cache: copy of ``makisu_tpu/cache/``'s KV stores, manager and
the local plane of chunk dedup (reference: lib/cache/ +
lib/cache/keyvalue/)."""

from makisu_tpu_torch.cache.chunks import ChunkStore, attach_chunk_dedup
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
    "CacheManager", "CacheMiss", "ChunkStore", "EMPTY_ENTRY", "FSStore",
    "MemoryStore", "NoopCacheManager", "attach_chunk_dedup",
    "decode_entry_full", "encode_entry",
]
