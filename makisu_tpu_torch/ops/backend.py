"""Device selection, the device plane's bounded probe and waits,
CUDA-event timing, span-launch tallies and the device plane's telemetry.

The port's entry points run on the card unless the caller asks for the
CPU: ``resolve_device(None)`` is ``cuda``, and a host without CUDA
raises instead of falling back, so no result is ever taken on the CPU
while it claims to be the card's.

The probe is the port's copy of ``makisu_tpu/ops/backend.py``'s
bounded, cached, phase-resolved readiness probe. A card that has
dropped off the bus, a driver that never answers or a kernel that never
ends does not raise: it blocks the caller forever. So the first
``backend_ready()`` runs the probe in a daemon thread and waits a
bounded time (``init_timeout()``); the chunk session, the hash service
and ``SnapshotHasher`` consult it before their first launch and raise
its summary when the card cannot come up (no degrade: chunk
fingerprints are cache identity, and nothing falls back to the CPU).
The result is cached process-wide; a wedge costs one bounded wait per
process, and a late success is picked up by later calls.

- The probe is PHASE-RESOLVED (``PROBE_PHASES``): driver discovery,
  CUDA context creation (the wedge point of a card that dropped off the
  bus), device enumeration (a Hopper card or it raises), the kernels'
  build or load (``ops/_build.py``) and the first dispatch (G1 on one
  4 MiB block against its plain version, then the S1 parity probe: the
  first full host→device→host round trip). Each phase is a
  ``metrics.span`` with ``device_probe`` start/done events, so a wedge
  names its phase.
- A WATCHER thread samples the probe thread's stack on an interval and,
  when the budget elapses, appends the ``wedged`` record to the
  device-session ledger (``utils/deviceprobe.py``); the terminal record
  (``ok``, ``failed``, ``ok_late``, ``failed_late``) follows completion.
- A wedge verdict is shared across processes through a small cache file
  keyed by the attachment (the CUDA attachment variables); a later
  process trusts it after a short grace, charged once per process, and
  any process whose probe succeeds deletes it.

Every host wait on the device plane after init goes through
``sync_bounded``: it polls a CUDA event until a deadline
(``sync_timeout()``) and raises ``TimeoutError`` naming the wait, so a
hung kernel fails the build instead of blocking it. An event can be
polled, so no thread is left parked behind the wait.

Known limitation (as the reference's): a wedge inside a C call that
holds the GIL freezes every Python thread, the watcher's included.
Context creation and kernel waits release it.

The telemetry half is the port's copy of the reference's device
execution section (``note_device_dispatch``, per-bucket latency rings,
``dispatch_stats``, ``device_health``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from makisu_tpu_torch.utils import metrics


def _profiler_span(name: str):
    """The span mirror (``metrics.set_span_mirror``): a
    ``record_function`` scope while torch's profiler records, so its
    trace holds the port's spans as ``user_annotation`` events on the
    clock of the kernels and copies; otherwise nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return torch.profiler.record_function(name)


# Installed where the port imports torch: every span opened from here on
# reaches a profiler trace that is recording.
metrics.set_span_mirror(_profiler_span)


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


_CU_STREAM_WAIT_VALUE_GEQ = 0x0
_driver_lib = None


def _driver():
    """libcuda with the two entry points ``KernelTimer`` calls."""
    global _driver_lib
    if _driver_lib is None:
        import ctypes
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuStreamWaitValue32_v2.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint]
        lib.cuStreamWaitValue32_v2.restype = ctypes.c_int
        lib.cuMemHostGetDevicePointer_v2.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p, ctypes.c_uint]
        lib.cuMemHostGetDevicePointer_v2.restype = ctypes.c_int
        _driver_lib = lib
    return _driver_lib


class KernelTimer:
    """The card's seconds in kernels: a pair of CUDA timing events around
    each launch (``launch``), summed by kernel name once every pair has
    completed (``seconds``: call it after waiting for the launches'
    results, so it waits for nothing).

    On an idle card a bare pair times the host: the start event fires
    as soon as it is enqueued, and the kernel starts only once the
    host's launch call reaches the card, tens of microseconds later
    (more under a profiler), longer than a G1 launch. So each pair is
    enqueued behind a wait on a pinned host word (the stream memory
    operation ``cuStreamWaitValue32``) that the host sets once the end
    event is enqueued: the card reaches the start event with the kernel
    queued right behind it. The word is set in a ``finally``, so a
    launch that raises never leaves its stream waiting."""

    def __init__(self) -> None:
        import ctypes
        self._word = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        self._word_np = self._word.numpy()
        addr = ctypes.c_uint64()
        err = _driver().cuMemHostGetDevicePointer_v2(
            ctypes.byref(addr), self._word.data_ptr(), 0)
        if err:
            raise RuntimeError(f"cuMemHostGetDevicePointer failed: CUDA "
                               f"driver error {err}")
        self._addr = addr.value
        self._seq = 0
        self._pairs: list[tuple] = []

    @contextlib.contextmanager
    def launch(self, kernel: str):
        """Time the launch of ``kernel`` made inside the block on the
        current stream."""
        seq = self._seq = self._seq % 0x7FFFFFFF + 1
        err = _driver().cuStreamWaitValue32_v2(
            torch.cuda.current_stream().cuda_stream, self._addr, seq,
            _CU_STREAM_WAIT_VALUE_GEQ)
        if err:
            raise RuntimeError(f"cuStreamWaitValue32 failed: CUDA driver "
                               f"error {err}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        try:
            start.record()
            yield
            end.record()
        finally:
            self._word_np[0] = seq
        self._pairs.append((kernel, start, end))

    def seconds(self) -> dict[str, float]:
        """Kernel name -> seconds of the pairs timed since the last call."""
        out: dict[str, float] = {}
        for kernel, start, end in self._pairs:
            out[kernel] = out.get(kernel, 0.0) + start.elapsed_time(end) / 1e3
        self._pairs = []
        return out


def timed_launch(timer: KernelTimer | None, kernel: str):
    """``timer.launch(kernel)``, or nothing without a timer."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.launch(kernel)


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


# -- the bounded probe -------------------------------------------------------

DEFAULT_TIMEOUT_SECONDS = 180.0
# How long a cross-process "wedged" verdict stays fresh: long enough
# that a farm's processes don't each re-pay the bounded wait while a
# wedge persists, short enough that a card that comes back is probed
# again within minutes.
DEFAULT_CACHE_TTL_SECONDS = 900.0
DEFAULT_SYNC_TIMEOUT_SECONDS = 300.0

# The environment variables that say which card a process attaches to:
# the verdict key folds their values in, and the ledger names those set.
ATTACHMENT_ENV = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                  "CUDA_DEVICE_ORDER", "CUDA_MPS_PIPE_DIRECTORY")

_lock = threading.Lock()
_done = threading.Event()
_result: list = [None]  # [None] until the probe thread finishes;
#                         then ["ok"] or [error summary string]
_started = False
_probe_start = 0.0  # monotonic time the probe thread was started
_timed_out = False  # a full bounded wait already elapsed once
_grace_spent = False  # the cached-verdict grace already elapsed once

# Probe sub-phases, in execution order. "context_init" is CUDA context
# creation, where a card that dropped off the bus parks; "kernel_build"
# is the counterpart of the reference's first compile (nvcc on a cold
# checkout); "first_dispatch" the first launch and readback.
PROBE_PHASES = ("driver_discovery", "context_init", "device_enumeration",
                "kernel_build", "first_dispatch")

# The first dispatch's shapes: one chunk-session block for G1 and the
# parity probe's spans up to the largest chunk for S1. On the CPU target
# (the tests' route) the plain versions take seconds at these sizes, so
# the probe runs them smaller there.
PROBE_BLOCK = 4 * 1024 * 1024
CPU_PROBE_BLOCK = 64 * 1024
CPU_PROBE_MAX_LEN = 1024

# Trajectory bound: consecutive identical deepest-frames collapse into
# one counted entry, so even an hours-long wedge stays a handful of
# entries; distinct-frame churn is trimmed from the front.
_SAMPLES_KEEP = 64
_SAMPLE_STACK_DEPTH = 12


class _ProbeTracker:
    """Phase + stack-sample state of this process's one probe attempt.
    Plain attribute stores and list appends only (GIL-atomic), so the
    forensics readers — /healthz, flight-recorder bundles from signal
    handlers — never need a lock the probe path might hold."""

    def __init__(self) -> None:
        self.source = "build"   # who started the probe (build|worker)
        self.device = "cuda"    # the probe's target (cuda, or cpu in tests)
        self.phases: list[dict] = []   # [{"phase", "seconds", "ok"}]
        self.current = ""              # phase currently executing
        self.samples: list[dict] = []  # [{"frame", "count", "stack"}]
        self.last_beat = 0.0           # monotonic: last phase event/sample
        self.verdict = ""              # ""|ok|failed|wedged|ok_late|...
        self.detail = ""
        # Set once a terminal ledger record (or the wedge record) has
        # been appended — tests and the smoke wait on this instead of
        # polling the filesystem.
        self.recorded = threading.Event()

    def phase_reached(self) -> str:
        """The last phase that COMPLETED ok ("" if none did)."""
        reached = ""
        for p in self.phases:
            if p.get("ok"):
                reached = p["phase"]
        return reached


_tracker = _ProbeTracker()


@contextlib.contextmanager
def _phase(name: str):
    """One probe sub-phase: a span on the global registry (visible in
    flight-recorder bundles as an open span while wedged) plus
    ``device_probe`` start/done heartbeat events on the event bus."""
    from makisu_tpu_torch.utils import events
    tracker = _tracker
    tracker.current = name
    tracker.last_beat = time.monotonic()
    events.emit("device_probe", phase=name, status="start")
    t0 = time.monotonic()
    ok = False
    try:
        with metrics.span(f"device_probe.{name}"):
            yield
        ok = True
    finally:
        dt = time.monotonic() - t0
        tracker.phases.append({"phase": name,
                               "seconds": round(dt, 4), "ok": ok})
        tracker.current = ""
        tracker.last_beat = time.monotonic()
        events.emit("device_probe", phase=name,
                    status="done" if ok else "error",
                    seconds=round(dt, 4))


def attachment_vars() -> list[str]:
    """The names of the CUDA attachment variables set in this process."""
    return sorted(k for k in ATTACHMENT_ENV if k in os.environ)


def _phase_driver_discovery(ctx: dict) -> None:
    """Is there a driver and a card: torch's CUDA build, the driver's
    device count and the attachment variables."""
    ctx["attachment"] = attachment_vars()
    ctx["cuda_build"] = torch.version.cuda
    ctx["available"] = torch.cuda.is_available()
    ctx["count"] = torch.cuda.device_count() if ctx["available"] else 0
    if ctx["device"].type == "cuda" and not ctx["available"]:
        raise RuntimeError(
            f"CUDA is not available (torch built for CUDA "
            f"{ctx['cuda_build'] or 'none'}; attachment "
            f"{', '.join(ctx['attachment']) or 'unset'})")


def _phase_context_init(ctx: dict) -> None:
    """CUDA context creation and one small allocation: where a card
    that dropped off the bus parks."""
    dev = ctx["device"]
    if dev.type == "cuda":
        torch.cuda.init()
        if dev.index is None:
            dev = ctx["device"] = torch.device(
                "cuda", torch.cuda.current_device())
    ctx["scratch"] = torch.empty(1, dtype=torch.uint8, device=dev)


def _driver_version() -> str:
    """The CUDA driver's version as the driver reports it, or "?"."""
    import ctypes
    try:
        version = ctypes.c_int()
        if ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(
                ctypes.byref(version)) == 0:
            return f"{version.value // 1000}.{version.value % 1000 // 10}"
    except OSError:
        pass
    return "?"


def _phase_device_enumeration(ctx: dict) -> None:
    """The card's name, capability, memory and driver; the kernels are
    built for sm_90a, so anything but a Hopper card raises."""
    dev = ctx["device"]
    if dev.type != "cuda":
        ctx["name"] = "cpu"
        return
    props = torch.cuda.get_device_properties(dev)
    ctx["name"] = props.name
    ctx["capability"] = f"sm_{props.major}{props.minor}"
    ctx["memory_bytes"] = props.total_memory
    ctx["driver"] = _driver_version()
    if (props.major, props.minor) != (9, 0):
        raise RuntimeError(
            f"{props.name} is {ctx['capability']}, not a Hopper card "
            f"(sm_90): the kernels are built for sm_90a")


def _phase_kernel_build(ctx: dict) -> None:
    """Load G1 and S1, building them with nvcc where the checkout has
    no library for their current sources (``ops/_build.py``). The CPU
    target runs the plain versions: nothing to build."""
    ctx["libraries"] = []
    if ctx["device"].type != "cuda":
        return
    from makisu_tpu_torch.ops import _build
    for name in _build.SOURCES:
        _build.library(name)
        ctx["libraries"].append(_build.library_path(name).name)


def _phase_first_dispatch(ctx: dict) -> None:
    """G1 on one block against its plain version, then the S1 parity
    probe: the first full host→device→host round trip, on a stream of
    the probe's own, every wait bounded."""
    import numpy as np

    from makisu_tpu_torch.ops import gear, gear_cuda, sha256_cuda
    dev = ctx["device"]
    cuda = dev.type == "cuda"
    n = PROBE_BLOCK if cuda else CPU_PROBE_BLOCK
    block = torch.from_numpy(np.random.default_rng(0xD15).integers(
        0, 256, n, dtype=np.uint8))
    stream = torch.cuda.Stream(dev) if cuda else None
    with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
        if cuda:
            x = block.pin_memory().to(dev, non_blocking=True)
            words = [gear_cuda.gear_bitmap(x), gear.gear_bitmap(x)]
            host = [torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
                    for w in words]
            for h, w in zip(host, words):
                h.copy_(w, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            sync_bounded(done, "probe bitmap readback")
        else:
            host = [gear_cuda.gear_bitmap(block), gear.gear_bitmap(block)]
        got, want = host
        bad = torch.nonzero(got != want)
        if len(bad):
            raise RuntimeError(
                f"gear kernel probe on {dev}: {len(bad)} of {got.numel()} "
                f"bitmap words of one {n}-byte block differ from the plain "
                f"version (first: word {int(bad[0])})")
        sha256_cuda.parity_probe(
            dev, max_len=gear.DEFAULT_MAX_SIZE if cuda else CPU_PROBE_MAX_LEN)


def _probe() -> None:
    ctx: dict = {"device": torch.device(_tracker.device)}
    try:
        for name in PROBE_PHASES:
            # globals() lookup at run time: tests monkeypatch
            # individual phase functions to simulate wedges.
            fn = globals()["_phase_" + name]
            with _phase(name):
                fn(ctx)
        _result[0] = "ok"
        _clear_cached_wedge()
    # The failure is the probe's verdict: backend_ready returns it.
    except Exception as e:  # check: allow(silent-swallow)
        _result[0] = f"backend init failed: {e}"
    finally:
        _done.set()


def _sample_interval() -> float:
    """Seconds between probe-thread stack samples
    (MAKISU_TPU_PROBE_SAMPLE_INTERVAL, default 1s)."""
    try:
        return max(float(os.environ.get(
            "MAKISU_TPU_PROBE_SAMPLE_INTERVAL", "1.0")), 0.01)
    except ValueError:
        return 1.0


# Frames that are the interpreter's parking lot, not a location:
# Event/Condition waits. A real wedge parks inside a C call (no Python
# frame below the caller at all); simulated wedges park in threading
# waits — skipping these names the caller either way.
_PARKING_FILES = ("threading.py",)


def _representative_frame(stack: list[str]) -> str:
    for entry in stack:
        if not any(f"({name}:" in entry for name in _PARKING_FILES):
            return entry
    return stack[0]


def _sample_probe_stack(tracker: _ProbeTracker, ident) -> None:
    """One stack sample of the probe thread: record the deepest
    meaningful Python frame (innermost first); consecutive identical
    frames collapse into a counted entry — "N identical samples" IS
    the wedge signature."""
    if ident is None:
        return
    frame = sys._current_frames().get(ident)
    if frame is None:
        return
    stack: list[str] = []
    f = frame
    while f is not None and len(stack) < _SAMPLE_STACK_DEPTH:
        code = f.f_code
        stack.append(f"{code.co_name} "
                     f"({os.path.basename(code.co_filename)}:"
                     f"{f.f_lineno})")
        f = f.f_back
    if not stack:
        return
    deepest = _representative_frame(stack)
    samples = tracker.samples
    if samples and samples[-1]["frame"] == deepest:
        samples[-1]["count"] += 1
    else:
        if len(samples) >= _SAMPLES_KEEP:
            del samples[:_SAMPLES_KEEP // 4]
        samples.append({"frame": deepest, "count": 1, "stack": stack})
    tracker.last_beat = time.monotonic()


def _recording_wanted() -> bool:
    """Whether probe attempts append to the device-session ledger. An
    explicit ``MAKISU_TPU_DEVICE_SESSIONS_DIR`` always decides (empty
    value = off); otherwise record exactly when the card is the probe's
    target, so CPU test runs never write into the checkout."""
    from makisu_tpu_torch.utils import deviceprobe
    if os.environ.get("MAKISU_TPU_DEVICE_SESSIONS_DIR") is not None:
        return deviceprobe.sessions_dir() is not None
    return _tracker.device.startswith("cuda")


def _record_attempt(tracker: _ProbeTracker, verdict: str, detail: str,
                    timeout: float, probe_start: float) -> None:
    """Append one ``makisu-tpu.deviceprobe.v1`` record for this probe
    attempt. Never raises — the ledger is forensics, not control
    flow."""
    try:
        if not _recording_wanted():
            return
        from makisu_tpu_torch.utils import deviceprobe
        record = {
            "schema": deviceprobe.SCHEMA,
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "source": tracker.source,
            "platform": tracker.device.split(":")[0],
            "attachment": {
                # Hashed key (raw values must not land in a shared
                # artifact) + the var NAMES present.
                "key": _platform_key(),
                "vars": attachment_vars(),
            },
            "verdict": verdict,
            "detail": (detail or "")[:300],
            "timeout_seconds": round(timeout, 1),
            "total_seconds": round(time.monotonic() - probe_start, 3),
            "phase_reached": tracker.phase_reached(),
            "wedged_phase": (tracker.current
                             if verdict == "wedged" else ""),
            "phases": [dict(p) for p in tracker.phases],
            "samples": [dict(s) for s in tracker.samples],
        }
        if deviceprobe.append_record(record) is not None:
            tracker.recorded.set()
    except Exception as e:  # noqa: BLE001 - ledger must never fail the probe
        from makisu_tpu_torch.utils import logging as _log
        _log.debug("device probe ledger write failed: %s", e)


def _watch(probe_thread: threading.Thread, timeout: float,
           done: threading.Event, tracker: _ProbeTracker,
           probe_start: float) -> None:
    """Sidecar watcher: samples the probe thread's stack on an
    interval; when the budget elapses without completion it appends the
    WEDGED ledger record (phase + trajectory), then keeps sampling so a
    late completion still leaves an ``ok_late``/``failed_late``
    record."""
    from makisu_tpu_torch.utils import events
    # This thread's own activity must not stamp the build-progress
    # clock it would otherwise keep fresh through a genuine wedge.
    events.suppress_progress_stamps()
    interval = _sample_interval()
    wedge_written = False
    while not done.wait(interval):
        try:
            _sample_probe_stack(tracker, probe_thread.ident)
            elapsed = time.monotonic() - probe_start
            if not wedge_written and timeout > 0 and elapsed >= timeout:
                wedge_written = True
                tracker.verdict = "wedged"
                tracker.detail = (
                    f"backend init did not complete within "
                    f"{timeout:g}s (wedged in {tracker.current or '?'})")
                _record_attempt(tracker, "wedged", tracker.detail,
                                timeout, probe_start)
                events.emit("device_probe", status="wedged",
                            phase=tracker.current,
                            elapsed=round(elapsed, 1))
        except Exception as e:  # noqa: BLE001 - watcher must never die early
            from makisu_tpu_torch.utils import logging as _log
            _log.debug("device probe watcher: %s", e)
    verdict = "ok" if _result[0] == "ok" else "failed"
    if wedge_written:
        verdict += "_late"
    tracker.verdict = verdict
    tracker.detail = "" if _result[0] == "ok" else str(_result[0] or "")
    _record_attempt(tracker, verdict, tracker.detail, timeout,
                    probe_start)
    tracker.recorded.set()  # terminal — even when recording is gated off


def wait_for_probe_record(timeout: float = 5.0) -> bool:
    """Block until this process's probe attempt has reached a recorded
    verdict (ledger appended, or recording gated off after
    completion)."""
    return _tracker.recorded.wait(timeout)


def init_timeout() -> float:
    """Seconds to wait for the device plane to come up
    (MAKISU_TPU_PROBE_TIMEOUT, with MAKISU_TPU_BACKEND_INIT_TIMEOUT as
    its alias; 0 disables the guard — callers then block natively)."""
    for var in ("MAKISU_TPU_PROBE_TIMEOUT",
                "MAKISU_TPU_BACKEND_INIT_TIMEOUT"):
        if os.environ.get(var):
            return float(os.environ[var])
    return DEFAULT_TIMEOUT_SECONDS


# -- cross-process wedge cache -------------------------------------------
#
# The first process to time out writes a small verdict file; later
# processes see a fresh verdict and raise within the short grace
# (_grace_seconds, default 2 s — long enough for a HEALTHY card's own
# probe to override stale hearsay). The file self-expires (TTL) and is
# deleted by any process whose probe succeeds.


def _cache_ttl() -> float:
    return float(os.environ.get("MAKISU_TPU_PROBE_CACHE_TTL",
                                str(DEFAULT_CACHE_TTL_SECONDS)))


def _cache_path() -> str:
    if os.environ.get("MAKISU_TPU_PROBE_CACHE"):
        return os.environ["MAKISU_TPU_PROBE_CACHE"]
    return os.path.join(tempfile.gettempdir(),
                        f"makisu-tpu-torch-wedged-{os.getuid()}.json")


def _platform_key() -> str:
    """Identity of the attachment a wedge verdict applies to: the
    probe's target platform and the values of the CUDA attachment
    variables, hashed before they leave the process."""
    parts = [_tracker.device.split(":")[0]]
    parts += [f"{k}={os.environ[k]}" for k in attachment_vars()]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:32]


def _grace_seconds() -> float:
    """How long a process honors its OWN probe before trusting another
    process's cached wedge verdict (MAKISU_TPU_PROBE_GRACE)."""
    try:
        return float(os.environ.get("MAKISU_TPU_PROBE_GRACE", "2.0"))
    except ValueError:
        return 2.0


def _read_cached_wedge() -> str | None:
    """A fresh same-attachment wedge verdict from another process, or
    None."""
    ttl = _cache_ttl()
    if ttl <= 0:
        return None
    try:
        with open(_cache_path(), encoding="utf-8") as f:
            rec = json.loads(f.read())
        age = time.time() - float(rec["time"])
        if age < 0 or age > ttl:
            return None
        if rec.get("platforms") != _platform_key():
            # "No verdict" and "a verdict for another attachment" differ:
            # the latter means this process pays its own bounded wait.
            from makisu_tpu_torch.utils import logging as _log
            _log.debug("ignoring wedge verdict for a different "
                       "attachment (pid %s)", rec.get("pid"))
            return None
        return (f"backend init wedged {age:.0f}s ago in another process "
                f"(pid {rec.get('pid')}: {rec.get('detail', '?')})")
    except FileNotFoundError:
        return None
    except Exception as e:  # noqa: BLE001 - cache is advisory
        from makisu_tpu_torch.utils import logging as _log
        _log.debug("unreadable wedge verdict: %s", e)
        return None


def _write_cached_wedge(detail: str) -> None:
    try:
        path = _cache_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({
                "time": time.time(),
                "pid": os.getpid(),
                "platforms": _platform_key(),
                "detail": detail,
            }))
        os.replace(tmp, path)
    except OSError as e:  # the cache is advisory
        from makisu_tpu_torch.utils import logging as _log
        _log.debug("wedge verdict not written: %s", e)


def _clear_cached_wedge() -> None:
    """Delete OUR attachment's wedge verdict only: a CPU-target probe
    must not erase the verdict a card's process paid the wait for."""
    try:
        path = _cache_path()
        with open(path, encoding="utf-8") as f:
            rec = json.loads(f.read())
        if rec.get("platforms") == _platform_key():
            os.unlink(path)
    except FileNotFoundError:
        pass  # no verdict: nothing to clear
    except Exception as e:  # noqa: BLE001 - cache is advisory
        from makisu_tpu_torch.utils import logging as _log
        _log.debug("wedge verdict not cleared: %s", e)


def backend_ready(timeout: float | None = None, source: str = "build",
                  device=None) -> str | None:
    """Block (bounded) until the device plane is up.

    Returns None when it is, else a failure summary. The wait is
    ``timeout`` seconds from PROBE START (default: ``init_timeout()``),
    so a process that warmed the probe early (the worker does at
    startup) pays only the remainder. A timeout cannot cancel the
    underlying init — the daemon thread stays parked — but the caller
    gets control back, the verdict is shared with other processes (the
    wedge cache above), and every later call re-checks instantly (and
    picks up a late success).

    ``source`` labels the ledger record and ``device`` is the probe's
    target (None: the card; ``"cpu"`` runs the phases on the plain
    versions, the tests' route) when THIS call starts the probe.
    """
    global _timed_out, _grace_spent
    if timeout is None:
        timeout = init_timeout()
    if timeout <= 0:
        return None  # guard disabled: callers block natively
    warm_probe(source=source, device=device)
    if _done.is_set():
        return None if _result[0] == "ok" else _result[0]
    if _timed_out:
        # One full bounded wait already elapsed in this process; don't
        # charge it again per session — report at once (a late init
        # completion flips _done and is picked up above).
        return "backend init still pending (card wedged?)"
    cached = _read_cached_wedge()
    if cached is not None:
        # Another process already paid the bounded wait — but give our
        # OWN probe a short grace first, once per process: a verdict can
        # outlive the wedge it recorded.
        with _lock:
            if _grace_spent:
                return cached
            _grace_spent = True
        grace = min(_grace_seconds(),
                    max(0.0, (_probe_start + timeout) - time.monotonic()))
        if grace > 0 and _done.wait(grace):
            return None if _result[0] == "ok" else _result[0]
        return cached
    remaining = (_probe_start + timeout) - time.monotonic()
    if remaining > 0 and _done.wait(remaining):
        return None if _result[0] == "ok" else _result[0]
    _timed_out = True
    detail = (f"backend init did not complete within {timeout:g}s "
              "(card wedged?)")
    _write_cached_wedge(detail)
    return detail


def require_ready(device: torch.device) -> None:
    """What the device plane's users (a chunk session, the hash
    service, ``SnapshotHasher``) call before their first launch on the
    card: ``backend_ready`` for ``device``, raising RuntimeError with its
    summary when the card did not come up, then S1's parity probe on
    ``device`` (done already when the probe's first dispatch ran there;
    the only one when the guard is off)."""
    from makisu_tpu_torch.ops import sha256_cuda
    summary = backend_ready(source="build", device=device)
    if summary is not None:
        raise RuntimeError(summary)
    sha256_cuda.parity_probe(device)


def warm_probe(source: str = "build", device=None) -> None:
    """Start the background probe without waiting (a worker's startup;
    also the first step of every ``backend_ready`` call), with its
    watcher thread beside it. ``device`` is the probe's target (None:
    the card)."""
    global _started, _probe_start
    with _lock:
        if not _started:
            _started = True
            _tracker.source = source
            _tracker.device = "cuda" if device is None else str(device)
            _probe_start = time.monotonic()
            # The probe and its watcher are the process's, not a build's:
            # they carry no build's registry or log sink.
            t = threading.Thread(  # check: allow(ctx-propagation)
                target=_probe, daemon=True, name="cuda-backend-probe")
            t.start()
            threading.Thread(  # check: allow(ctx-propagation)
                target=_watch,
                args=(t, init_timeout(), _done, _tracker, _probe_start),
                daemon=True, name="cuda-probe-watch").start()


# -- bounded host waits ------------------------------------------------------

# sync_bounded's polling: the first pause, doubled up to the last.
_POLL_FIRST_SECONDS = 20e-6
_POLL_MAX_SECONDS = 1e-3


def sync_timeout() -> float:
    """Seconds to wait for a device→host readback
    (MAKISU_TPU_SYNC_TIMEOUT, default 300; 0 turns the bound off)."""
    return float(os.environ.get("MAKISU_TPU_SYNC_TIMEOUT",
                                str(DEFAULT_SYNC_TIMEOUT_SECONDS)))


def sync_bounded(event, what: str, timeout: float | None = None) -> None:
    """Wait for ``event`` (a CUDA event, or anything with ``query()``
    and ``synchronize()``; None: nothing to wait for) at most
    ``timeout`` seconds (default ``sync_timeout()``; 0 waits natively).

    Polls ``event.query()`` with a short backoff and raises
    ``TimeoutError`` naming ``what`` and the seconds once the deadline
    passes: a hung kernel or a lost card then fails the caller instead
    of blocking it. A device error raises as it is. Exports
    ``makisu_device_sync_seconds`` and
    ``makisu_device_sync_total{result=ok|timeout|error}``."""
    if event is None:
        return
    if timeout is None:
        timeout = sync_timeout()
    t0 = time.monotonic()
    result = "error"
    try:
        if timeout <= 0:
            event.synchronize()
        else:
            deadline = t0 + timeout
            pause = _POLL_FIRST_SECONDS
            while not event.query():
                now = time.monotonic()
                if now >= deadline:
                    result = "timeout"
                    raise TimeoutError(
                        f"{what} did not complete within {timeout:g}s "
                        "(kernel hung or card lost?)")
                time.sleep(min(pause, deadline - now))
                pause = min(2 * pause, _POLL_MAX_SECONDS)
        result = "ok"
    finally:
        metrics.observe(metrics.DEVICE_SYNC_SECONDS, time.monotonic() - t0)
        metrics.counter_add(metrics.DEVICE_SYNC_TOTAL, result=result)


# -- probe introspection (healthz, history, forensics) ---------------------


def probe_snapshot() -> dict:
    """JSON-ready state of this process's probe attempt, in the
    reference's shape. Lock-free by construction (tracker fields are
    GIL-atomic stores), so the flight recorder can call it from a signal
    handler.

    ``state``: ``disabled`` (guard off) | ``absent`` (never started) |
    ``pending`` | ``ok`` | ``failed`` | ``wedged`` (budget elapsed,
    still parked)."""
    timeout = init_timeout()
    if timeout <= 0:
        state = "disabled"
    elif not _started:
        state = "absent"
    elif _done.is_set():
        state = "ok" if _result[0] == "ok" else "failed"
    elif time.monotonic() - _probe_start >= timeout:
        state = "wedged"
    else:
        state = "pending"
    tracker = _tracker
    samples = [dict(s) for s in
               metrics.snapshot_concurrent(tracker.samples)]
    out: dict = {
        "state": state,
        "phase": tracker.current,
        "phase_reached": tracker.phase_reached(),
        "phases": [dict(p) for p in
                   metrics.snapshot_concurrent(tracker.phases)],
        "samples": samples,
        "sample_count": sum(int(s.get("count", 0)) for s in samples),
    }
    if _started:
        out["source"] = tracker.source
        out["elapsed_seconds"] = round(
            time.monotonic() - _probe_start, 3)
        if tracker.last_beat:
            out["heartbeat_age_seconds"] = round(
                time.monotonic() - tracker.last_beat, 3)
    if samples:
        out["deepest_frame"] = samples[-1]["frame"]
    detail = tracker.detail or (
        _result[0] if _done.is_set() and _result[0] != "ok" else "")
    if detail:
        out["detail"] = str(detail)[:300]
    return out


def probe_label() -> str:
    """One-word device-route label for history records
    (``utils/history.py``): ``ok`` | ``wedged`` | ``failed`` |
    ``pending`` | ``absent`` | ``disabled``."""
    return probe_snapshot()["state"]


# -- device execution telemetry ----------------------------------------------
#
# One S1 launch is one dispatched program. The port has one program
# capacity per session, its ring's bytes, so that is the bucket. What
# crosses to the card is the stream's slot copies plus the span metadata
# (the ring ships no padding), so the padding series is not written.

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

    Exports, per bucket: ``makisu_device_dispatch_seconds`` (the host's
    wait for the digests, not the card's time: that is
    ``makisu_device_busy_seconds_total``, from CUDA events around each
    launch), ``makisu_device_compile_seconds`` (the process's first
    launch of ``kernel``) and ``makisu_device_h2d_bytes_total``. Spans
    ship no padding, so ``makisu_device_padding_waste_bytes_total`` is
    not written."""
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


def dispatch_stats() -> dict:
    """Exact per-bucket dispatch-latency percentiles over the recent
    ring (the ``/healthz`` device section's latency digest)."""
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
    snap = probe_snapshot()
    probe = {"state": snap["state"]}
    for key in ("phase", "phase_reached", "sample_count", "source",
                "elapsed_seconds", "heartbeat_age_seconds",
                "deepest_frame", "detail"):
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
        # The reference's key; spans ship no padding.
        "padding_waste_bytes": 0,
    }
