"""Process resource sampling: RSS, CPU time, fds, I/O — attributed to
open spans.

The telemetry so far (metrics.py spans, events.py) explains where a
build's *time* went; this module explains where its *memory and CPU*
went, and — through the flight recorder — what the process looked like
right before it died. One daemon sampler thread per process:

- publishes process gauges into the global registry
  (``makisu_process_rss_bytes``, ``makisu_process_cpu_seconds``,
  ``makisu_process_open_fds``, ``makisu_process_threads``,
  ``makisu_process_io_read_bytes`` / ``_write_bytes``) — what the
  worker's ``/metrics`` scrape sees;
- attributes each sample to the currently-open spans
  (``metrics.attribute_resource_sample``): every open span tracks its
  peak RSS, and the CPU burned between samples is charged to the open
  *leaf* spans (split evenly across concurrent leaves), so
  ``makisu-tpu report`` can print peak-RSS/CPU per build phase;
- keeps a bounded recent trajectory (:func:`trajectory`) that the
  flight recorder folds into diagnostic bundles — the "was RSS
  climbing toward the OOM?" record.

Readings come straight from ``/proc/self`` (stdlib-only, no psutil);
on hosts without procfs every field degrades to what ``os.times`` and
``resource.getrusage`` can supply rather than failing. Sampling must
never fail a build: the loop swallows per-tick errors and keeps going.

Copy of ``makisu_tpu/utils/resources.py``; the process sampler is
this package's own (one per package in a process that loads both).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any

from makisu_tpu_torch.utils import metrics

DEFAULT_INTERVAL = 0.5          # seconds between samples
TRAJECTORY_KEEP = 240           # recent samples kept for bundles (~2min)

_PAGE_SIZE = 4096
try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):  # pragma: no cover
    pass


def _rss_bytes() -> int:
    """Current resident set size. ``/proc/self/statm`` field 2 is
    resident pages; the fallback (no procfs) is ru_maxrss — a PEAK,
    but better than nothing on non-Linux dev hosts."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        try:  # pragma: no cover - non-procfs fallback
            import resource as _resource
            return _resource.getrusage(
                _resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # noqa: BLE001
            return 0


def _open_fds() -> int | None:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:  # pragma: no cover - no procfs
        return None


def _proc_io() -> dict[str, int]:
    """``/proc/self/io`` read_bytes/write_bytes (actual storage I/O).
    May be absent (no procfs) or unreadable (hardened kernels)."""
    out: dict[str, int] = {}
    try:
        with open("/proc/self/io", "rb") as f:
            for line in f:
                key, _, value = line.partition(b":")
                if key in (b"read_bytes", b"write_bytes"):
                    try:
                        out[key.decode()] = int(value)
                    except ValueError:
                        pass
    except OSError:
        pass
    return out


def read_sample() -> dict[str, Any]:
    """One point-in-time resource sample (JSON-ready)."""
    times = os.times()
    sample: dict[str, Any] = {
        "ts": round(time.time(), 6),
        "rss_bytes": _rss_bytes(),
        "cpu_seconds": round(times.user + times.system, 6),
        "threads": threading.active_count(),
    }
    fds = _open_fds()
    if fds is not None:
        sample["open_fds"] = fds
    io = _proc_io()
    if io:
        sample["io_read_bytes"] = io.get("read_bytes", 0)
        sample["io_write_bytes"] = io.get("write_bytes", 0)
    return sample


class ResourceSampler:
    """Background sampler; one per process (see :func:`ensure_started`).

    The trajectory deque is appended lock-free (``deque(maxlen=...)``
    appends are atomic) so the flight recorder can read it from a
    signal handler without any lock-ordering risk."""

    def __init__(self, interval: float = DEFAULT_INTERVAL) -> None:
        self.interval = max(float(interval), 0.05)
        self._trajectory: "collections.deque[dict]" = \
            collections.deque(maxlen=TRAJECTORY_KEEP)
        self._last_cpu: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sample_once(self) -> dict[str, Any]:
        """Take one sample: record it, publish gauges, attribute to
        open spans. Split out of the loop so tests (and the flight
        recorder's dump path) can sample deterministically."""
        sample = read_sample()
        self._trajectory.append(sample)
        g = metrics.global_registry()
        g.gauge_set(metrics.PROCESS_RSS_BYTES, sample["rss_bytes"])
        g.gauge_set(metrics.PROCESS_CPU_SECONDS, sample["cpu_seconds"])
        g.gauge_set(metrics.PROCESS_THREADS, sample["threads"])
        if "open_fds" in sample:
            g.gauge_set(metrics.PROCESS_OPEN_FDS, sample["open_fds"])
        if "io_read_bytes" in sample:
            g.gauge_set(metrics.PROCESS_IO_READ_BYTES,
                        sample["io_read_bytes"])
            g.gauge_set(metrics.PROCESS_IO_WRITE_BYTES,
                        sample["io_write_bytes"])
        cpu_delta = 0.0
        if self._last_cpu is not None:
            cpu_delta = max(sample["cpu_seconds"] - self._last_cpu, 0.0)
        self._last_cpu = sample["cpu_seconds"]
        metrics.attribute_resource_sample(sample["rss_bytes"], cpu_delta)
        return sample

    def trajectory(self) -> list[dict]:
        # Race-retried, not locked: the flight recorder reads this
        # from signal handlers while the sampler thread appends.
        return metrics.snapshot_concurrent(self._trajectory)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - sampling never fails a build
                pass

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="resource-sampler", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# -- process singleton ------------------------------------------------------

_sampler: ResourceSampler | None = None
_sampler_lock = threading.Lock()


def ensure_started(interval: float | None = None) -> ResourceSampler:
    """Start (or return) the process sampler. Interval resolution:
    explicit argument, then ``MAKISU_TPU_RESOURCE_INTERVAL`` seconds,
    then the 0.5s default. Idempotent — the CLI calls it on every
    invocation and a worker's many builds share one thread."""
    global _sampler
    with _sampler_lock:
        if _sampler is None:
            if interval is None:
                try:
                    interval = float(os.environ.get(
                        "MAKISU_TPU_RESOURCE_INTERVAL", "") or
                        DEFAULT_INTERVAL)
                except ValueError:
                    interval = DEFAULT_INTERVAL
            _sampler = ResourceSampler(interval)
        _sampler.start()
        return _sampler


def trajectory() -> list[dict]:
    """Recent samples (empty when the sampler never started) — the
    resource-trajectory section of diagnostic bundles. Reads the
    singleton WITHOUT ``_sampler_lock``: a signal handler may have
    interrupted ``ensure_started``/``stop`` mid-hold, and a stale
    module-global read (atomic under the GIL) is harmless here."""
    sampler = _sampler
    return sampler.trajectory() if sampler is not None else []


def stop() -> None:
    """Stop the process sampler (tests)."""
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
