"""The commit pipeline's worker counts, its shared thread pool and
context-carrying submission.

Copy of ``makisu_tpu/utils/concurrency.py``'s ``hash_workers`` (with its
context override), ``compress_workers`` and their setters, ``hash_pool``,
``submit_ctx`` and ``ctx_map``. The chunk store's existence probes and
the pgzip writer's deflate lanes run on the pool while a layer commits.
``MAKISU_TPU_HASH_WORKERS`` / ``--hash-workers`` set the pipeline count
(default ``min(8, cpu)``, and 1 below 4 cores);
``MAKISU_TPU_COMPRESS_WORKERS`` / ``--compress-workers`` set the deflate
lanes (default ``min(8, cpu)``). Both are throughput knobs only: the
bytes are the same at every count. ``hash_linger_ms`` is the shared hash
service's batch linger (``--hash-linger-ms`` /
``MAKISU_TPU_HASH_LINGER_MS``, default 2 ms), one per process.
"""

from __future__ import annotations

import contextvars
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable

_hash_workers_override: "contextvars.ContextVar[int | None]" = \
    contextvars.ContextVar("makisu_torch_hash_workers", default=None)
_compress_workers_override: "contextvars.ContextVar[int | None]" = \
    contextvars.ContextVar("makisu_torch_compress_workers", default=None)


def _env_count(name: str) -> int | None:
    env = os.environ.get(name, "")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass  # configuration never fails a build
    return None


def default_hash_workers() -> int:
    """``min(8, cpu)``, except that hosts under 4 cores default to 1
    (the pooled stages' interpreter-lock handoffs cost more there than
    the overlap wins)."""
    cpu = os.cpu_count() or 1
    return 1 if cpu < 4 else min(8, cpu)


def hash_workers() -> int:
    """Commit-pipeline worker count of this context: the flag, else
    ``MAKISU_TPU_HASH_WORKERS``, else the default."""
    override = _hash_workers_override.get()
    if override is not None:
        return max(1, override)
    return _env_count("MAKISU_TPU_HASH_WORKERS") or default_hash_workers()


def set_hash_workers(n: int | None):
    """Bind a per-context worker count (the CLI flag). Returns a token
    for :func:`reset_hash_workers`."""
    return _hash_workers_override.set(n)


def reset_hash_workers(token) -> None:
    _hash_workers_override.reset(token)


def default_compress_workers() -> int:
    return min(8, os.cpu_count() or 1)


def compress_workers() -> int:
    """Deflate lanes of the pgzip writer in this context: the flag, else
    ``MAKISU_TPU_COMPRESS_WORKERS``, else ``min(8, cpu)``."""
    override = _compress_workers_override.get()
    if override is not None:
        return max(1, override)
    return (_env_count("MAKISU_TPU_COMPRESS_WORKERS")
            or default_compress_workers())


def set_compress_workers(n: int | None):
    """Bind a per-context lane count (the CLI flag). Returns a token for
    :func:`reset_compress_workers`."""
    return _compress_workers_override.set(n)


def reset_compress_workers(token) -> None:
    _compress_workers_override.reset(token)


# The shared hash service's batch linger (ms). Here, with no chunker
# import, so the command line reads and sets it without loading the
# device stack. Process-wide: the service batches across builds, so
# there is one linger per process.
_DEFAULT_LINGER_MS = 2.0
_linger_override_ms: float | None = None


def set_hash_linger_ms(ms: float | None) -> None:
    """Process-wide linger override (the ``--hash-linger-ms`` flag); it
    takes effect for hash services made afterwards (a worker sets it
    before its first build makes the shared service)."""
    global _linger_override_ms
    _linger_override_ms = ms


def hash_linger_ms() -> float:
    """The linger in ms: the flag, else ``MAKISU_TPU_HASH_LINGER_MS``,
    else 2 ms."""
    if _linger_override_ms is not None:
        return max(0.0, _linger_override_ms)
    env = os.environ.get("MAKISU_TPU_HASH_LINGER_MS", "")
    if env:
        try:
            return max(0.0, float(env))
        except ValueError:
            pass  # configuration never fails a build
    return _DEFAULT_LINGER_MS


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


def submit_ctx(pool, fn: Callable[..., Any], *args: Any):
    """``pool.submit`` with the caller's contextvars carried into the
    task (pool threads start with an empty context)."""
    ctx = contextvars.copy_context()
    return pool.submit(ctx.run, fn, *args)


def ctx_map(pool, fn: Callable[[Any], Any], items: Iterable[Any]) -> list:
    """``pool.map`` with the caller's contextvars carried into every task;
    each task runs in its own copy (one Context cannot be entered by two
    threads at once)."""
    jobs = [(contextvars.copy_context(), item) for item in items]
    return list(pool.map(lambda job: job[0].run(fn, job[1]), jobs))
