"""Device selection, CUDA-event timing and per-bucket dispatch tallies.

The port's entry points run on the card unless the caller asks for the
CPU: ``resolve_device(None)`` is ``cuda``, and a host without CUDA
raises instead of falling back, so no result is ever taken on the CPU
while it claims to be the card's.
"""

from __future__ import annotations

import dataclasses
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card. Raises when CUDA is asked for (or defaulted
    to) on a host without it; pass ``device="cpu"`` to run the plain
    versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; the default device is "
            "the card; pass device=\"cpu\" to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


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
class BucketTally:
    """Lane-hash dispatches of one bucket (its lane capacity in bytes)."""

    dispatches: int = 0
    lanes: int = 0          # lanes shipped (filled or not)
    filled: int = 0         # lanes carrying a chunk
    real_bytes: int = 0     # chunk bytes in the filled lanes
    h2d_bytes: int = 0      # the whole [lanes, cap] buffer ships
    padding_bytes: int = 0  # filled * cap - real_bytes
    readback_seconds: float = 0.0


_tally_lock = threading.Lock()
_tallies: dict[int, BucketTally] = {}


def note_device_dispatch(bucket: int, lanes: int, filled: int,
                         real_bytes: int, seconds: float) -> None:
    """Record one lane-hash dispatch of ``bucket``: ``lanes`` shipped,
    ``filled`` of them holding ``real_bytes``, its readback having waited
    ``seconds``."""
    with _tally_lock:
        t = _tallies.setdefault(bucket, BucketTally())
        t.dispatches += 1
        t.lanes += lanes
        t.filled += filled
        t.real_bytes += real_bytes
        t.h2d_bytes += lanes * bucket
        t.padding_bytes += max(filled * bucket - real_bytes, 0)
        t.readback_seconds += seconds


def dispatch_stats() -> dict[int, dict]:
    with _tally_lock:
        return {b: dataclasses.asdict(t) for b, t in sorted(_tallies.items())}


def reset_dispatch_stats() -> None:
    with _tally_lock:
        _tallies.clear()
