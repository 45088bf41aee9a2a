"""Device selection, CUDA-event timing, span-launch tallies and the
device plane's telemetry.

The port's entry points run on the card unless the caller asks for the
CPU: ``resolve_device(None)`` is ``cuda``, and a host without CUDA
raises instead of falling back, so no result is ever taken on the CPU
while it claims to be the card's.

The telemetry half is the port's copy of ``makisu_tpu/ops/backend.py``'s
device execution section (``note_device_dispatch``, per-bucket latency
rings, ``dispatch_stats``, ``device_health``), without the JAX init
probe tracker. Its probe state is the port's own device plane: ``absent``
until a CUDA device resolves, then ``pending`` until the S1 parity probe
passes (``ok``) or fails (``failed``).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

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


def span_launch_stats() -> dict:
    """Every span launch noted since the last reset, and their sums."""
    with _tally_lock:
        rows = [dataclasses.asdict(t) for t in _launches]
    total = {k: sum(r[k] for r in rows)
             for k in ("spans", "live_bytes", "h2d_bytes",
                       "readback_seconds")}
    return {"launches": len(rows), **total, "per_launch": rows}


def reset_span_launch_stats() -> None:
    with _tally_lock:
        _launches.clear()


# -- the parity probe's state ------------------------------------------------

# Set by ops/sha256_cuda.parity_probe; plain stores, so a signal
# handler's bundle reads them without a lock.
_probe_state: str | None = None
_probe_detail = ""
_probe_start = 0.0


def note_probe(state: str, detail: str = "") -> None:
    """Record the S1 parity probe's progress: ``pending`` when it
    starts, then ``ok`` or ``failed``."""
    global _probe_state, _probe_detail, _probe_start
    if state == "pending":
        _probe_start = time.monotonic()
    _probe_state, _probe_detail = state, detail


def probe_snapshot() -> dict:
    """JSON-ready state of this process's device plane, in the shape of
    the reference's probe snapshot (doctor and history read it).

    ``state``: ``absent`` (no CUDA device resolved) | ``pending`` |
    ``ok`` | ``failed``."""
    if _route is None:
        state = "absent"
    else:
        state = _probe_state or "pending"
    out: dict = {"state": state,
                 "phase": "sha_parity_probe" if state == "pending"
                 and _probe_state else "",
                 "phase_reached": "sha_parity_probe"
                 if _probe_state else "",
                 "phases": [], "samples": [], "sample_count": 0}
    if _probe_state:
        out["source"] = "build"
        out["elapsed_seconds"] = round(time.monotonic() - _probe_start, 3)
    if _probe_detail:
        out["detail"] = _probe_detail[:300]
    return out


def probe_label() -> str:
    """One-word device-route label for history records."""
    return probe_snapshot()["state"]


# -- device execution telemetry ----------------------------------------------
#
# One S1 launch is one dispatched program. The port has one program
# capacity per session, its ring's bytes, so that is the bucket. What
# crosses to the card is the stream's slot copies plus the span metadata
# (the ring ships no padding), so the padding series is exported at 0.

_DISPATCH_RING_KEEP = 256

_dispatch_lock = threading.Lock()
_dispatch_rings: dict[int, "collections.deque[float]"] = {}
_compiled: set[str] = set()


def launched(kernel: str) -> bool:
    """Whether ``kernel``'s first launch in this process was noted."""
    return kernel in _compiled


def note_first_launch(kernel: str, bucket: int, seconds: float) -> None:
    """Export the process's first launch of ``kernel`` (``gear`` or
    ``sha256``; it pays the library's load) as
    ``makisu_device_compile_seconds{bucket}``. Later calls are no-ops."""
    from makisu_tpu_torch.utils import metrics
    with _dispatch_lock:
        if kernel in _compiled:
            return
        _compiled.add(kernel)
    metrics.gauge_set(metrics.DEVICE_COMPILE_SECONDS, seconds,
                      bucket=bucket)


def note_device_dispatch(bucket: int, lanes: int, filled: int,
                         real_bytes: int, seconds: float,
                         h2d_bytes: int, kernel: str = "sha256") -> None:
    """Record one S1 launch over a ring of ``bucket`` bytes: ``lanes``
    spans, ``filled`` of them carrying chunk bytes (all of them: a span
    is a chunk), ``real_bytes`` their live bytes, ``seconds`` the host's
    wait for the digests, ``h2d_bytes`` what crossed to the card for it
    (the slot copies since the last launch plus the span metadata).

    Exports, per bucket: ``makisu_device_dispatch_seconds``,
    ``makisu_device_compile_seconds`` (the process's first launch of
    ``kernel``), ``makisu_device_h2d_bytes_total`` and
    ``makisu_device_padding_waste_bytes_total``."""
    from makisu_tpu_torch.utils import metrics
    with _dispatch_lock:
        ring = _dispatch_rings.get(bucket)
        if ring is None:
            ring = _dispatch_rings[bucket] = collections.deque(
                maxlen=_DISPATCH_RING_KEEP)
        ring.append(seconds)
    note_first_launch(kernel, bucket, seconds)
    metrics.observe(metrics.DEVICE_DISPATCH_SECONDS, seconds,
                    bucket=bucket)
    metrics.counter_add(metrics.DEVICE_H2D_BYTES, h2d_bytes, bucket=bucket)
    # Every span ships only its live bytes: no padding, but the series
    # exists as the reference's does.
    metrics.counter_add(metrics.DEVICE_PADDING_WASTE, 0, bucket=bucket)


def dispatch_stats() -> dict:
    """Exact per-bucket dispatch-latency percentiles over the recent
    ring (the ``/healthz`` device section's latency digest)."""
    from makisu_tpu_torch.utils import metrics
    with _dispatch_lock:
        rings = {b: list(r) for b, r in _dispatch_rings.items()}
    return {str(b): metrics.percentile_stats(v)
            for b, v in sorted(rings.items())}


def kernel_launches() -> dict:
    """The kernel wrappers' launch counts in this process (each adds one
    where it launches its kernel); a wrapper not imported yet counts 0."""
    import sys
    gear = sys.modules.get("makisu_tpu_torch.ops.gear_cuda")
    sha = sys.modules.get("makisu_tpu_torch.ops.sha256_cuda")
    return {"gear_bitmap": gear.launches if gear else 0,
            "sha256_spans": sha.launches if sha else 0,
            "sha256_multi": sha.multi_launches if sha else 0}


def device_health() -> dict:
    """The ``device`` section of a worker's ``/healthz``: the probe
    state, the kernel wrappers' launch counts, the card's allocated
    bytes (once CUDA is initialised) and the execution plane's
    per-bucket dispatch digests and byte totals."""
    from makisu_tpu_torch.utils import metrics
    snap = probe_snapshot()
    probe = {"state": snap["state"]}
    for key in ("phase", "phase_reached", "sample_count", "source",
                "elapsed_seconds", "detail"):
        if snap.get(key) not in (None, "", 0) or key == "sample_count":
            probe[key] = snap.get(key)
    g = metrics.global_registry()
    memory = {}
    if torch.cuda.is_initialized():
        # The card's bytes held by this process's tensors, now and at
        # the peak: a worker's sessions must give their rings back.
        memory = {"allocated_bytes": torch.cuda.memory_allocated(),
                  "max_allocated_bytes": torch.cuda.max_memory_allocated()}
    return {
        "probe": probe,
        "kernel_launches": kernel_launches(),
        "memory": memory,
        "dispatch_seconds": dispatch_stats(),
        "h2d_bytes": int(g.counter_total(metrics.DEVICE_H2D_BYTES)),
        "padding_waste_bytes": int(
            g.counter_total(metrics.DEVICE_PADDING_WASTE)),
    }
