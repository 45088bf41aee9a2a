"""Device selection, CUDA-event timing and span-launch tallies.

The port's entry points run on the card unless the caller asks for the
CPU: ``resolve_device(None)`` is ``cuda``, and a host without CUDA
raises instead of falling back, so no result is ever taken on the CPU
while it claims to be the card's.
"""

from __future__ import annotations

import dataclasses
import threading

import torch


# The kernel route this process resolved: set the first time a CUDA
# device resolves, never unset (see kernel_route).
_route: str | None = None


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card. Raises when CUDA is asked for (or defaulted
    to) on a host without it; pass ``device="cpu"`` to run the plain
    versions on the CPU."""
    global _route
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; the default device is "
            "the card; pass device=\"cpu\" to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if dev.type == "cuda" and _route is None:
        from makisu_tpu_torch.ops import _build
        _route = ",".join(_build.library_path(name).stem
                          for name in _build.SOURCES)
    return dev


def kernel_route() -> str | None:
    """The kernels this process runs its layers on, once a CUDA device
    has resolved: the G1 and S1 library names, which carry the hash of
    their sources and nvcc flags (the target, sm_90a, among them). None
    before that. Reading it never builds or loads a library."""
    return _route


def time_cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream: one pair of
    CUDA events around ``reps`` calls enqueued back to back, after
    ``warmup`` calls. The host enqueues each call while the card runs
    the one before, so a call that takes longer on the card than on the
    host is timed by the card."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@dataclasses.dataclass
class SpanLaunch:
    """One span SHA-256 launch of a chunk session."""

    spans: int              # chunks hashed
    live_bytes: int         # their bytes
    h2d_bytes: int          # span metadata shipped (offset + length)
    readback_seconds: float = 0.0  # host wait for the digests


_tally_lock = threading.Lock()
_launches: list[SpanLaunch] = []


def note_span_launch(launch: SpanLaunch) -> None:
    with _tally_lock:
        _launches.append(launch)


def dispatch_stats() -> dict:
    """Every span launch noted since the last reset, and their sums."""
    with _tally_lock:
        rows = [dataclasses.asdict(t) for t in _launches]
    total = {k: sum(r[k] for r in rows)
             for k in ("spans", "live_bytes", "h2d_bytes",
                       "readback_seconds")}
    return {"launches": len(rows), **total, "per_launch": rows}


def reset_dispatch_stats() -> None:
    with _tally_lock:
        _launches.clear()
