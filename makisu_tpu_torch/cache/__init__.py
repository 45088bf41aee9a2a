"""Layer cache: copy of ``makisu_tpu/cache/``'s KV stores (memory, file,
Redis, HTTP), manager and chunk dedup (reference: lib/cache/ +
lib/cache/keyvalue/)."""

from makisu_tpu_torch.cache.chunks import ChunkStore, attach_chunk_dedup
from makisu_tpu_torch.cache.kv import (
    FSStore,
    HTTPStore,
    MemoryStore,
    RedisError,
    RedisStore,
)
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
    "HTTPStore", "MemoryStore", "NoopCacheManager", "RedisError",
    "RedisStore", "attach_chunk_dedup",
    "decode_entry_full", "encode_entry",
]
