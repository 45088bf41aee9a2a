"""The commit pipeline's worker count and shared thread pool.

Copy of ``hash_workers`` and ``hash_pool`` from
``makisu_tpu/utils/concurrency.py``: the chunk store's existence probes
run on the pool while a layer commits. ``MAKISU_TPU_HASH_WORKERS`` sets
the count (default ``min(8, cpu)``, and 1 below 4 cores).
"""

from __future__ import annotations

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor


def hash_workers() -> int:
    """Commit-pipeline worker count: ``MAKISU_TPU_HASH_WORKERS``, else
    ``min(8, cpu)``, except that hosts under 4 cores default to 1 (the
    pooled stages' interpreter-lock handoffs cost more there than the
    overlap wins)."""
    env = os.environ.get("MAKISU_TPU_HASH_WORKERS", "")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass  # configuration never fails a build
    cpu = os.cpu_count() or 1
    return 1 if cpu < 4 else min(8, cpu)


_hash_pool: ThreadPoolExecutor | None = None
_hash_pool_lock = threading.Lock()


def hash_pool() -> ThreadPoolExecutor:
    """Process-wide thread pool of the commit pipeline; threads spawn
    lazily. First use also drops the interpreter's switch interval from
    5 ms to 1 ms: at 5 ms a pool task can stall a whole interval behind
    the commit's producer thread."""
    global _hash_pool
    with _hash_pool_lock:
        if _hash_pool is None:
            sys.setswitchinterval(0.001)
            _hash_pool = ThreadPoolExecutor(
                max_workers=max(8, os.cpu_count() or 1),
                thread_name_prefix="commit-pipe")
        return _hash_pool
