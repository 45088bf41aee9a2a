"""Failure forensics: flight recorder, stall watchdog, diagnostic bundles.

Everything in the telemetry layer so far explains builds that FINISH —
the span tree materializes at exit, ``makisu-tpu report`` reads a
complete ``--metrics-out`` file. A build that hangs, OOMs, or is
SIGTERM'd by a CI timeout leaves nothing. This module is the black box
for those builds:

- :class:`FlightRecorder` — a per-build bounded ring buffer holding the
  last-N build events (subscribed to ``utils/events.py``), recent log
  records (via the ``utils/logging.py`` tap), and whatever the resource
  sampler (``utils/resources.py``) has collected. Always armed by
  ``cli.main``; costs a lock-free deque append per event.
- :func:`FlightRecorder.dump` — renders one JSON **diagnostic bundle**:
  the ring buffers, every open span with its age, all-thread stack
  traces (``sys._current_frames``), the transfer engine's in-flight
  state, a metrics snapshot, and build identity. Written atomically;
  triggered on build failure, stall, SIGTERM, or SIGUSR1.
- :class:`StallWatchdog` — a daemon thread that fires a ``stall`` event
  and dumps a bundle when the event bus and the transfer engine both
  make no progress for a configurable window. The idle clock is
  :func:`last_progress_seconds`, which the worker's ``/healthz`` also
  reports.
- :func:`render_doctor` — the ``makisu-tpu doctor BUNDLE`` output: a
  human diagnosis (stuck span, wedged thread, resource trajectory)
  from a bundle.

Signal-safety: bundles can be produced from inside a SIGTERM handler
running in the main thread, which may have interrupted code holding
telemetry locks. Every structure the dump path reads is therefore
either lock-free (ring deques, the open-span dict) or probed with a
timeout and skipped when unavailable (the metrics registry lock) —
a dump degrades, it never deadlocks the dying process.

Copy of ``makisu_tpu/utils/flightrecorder.py``. The device section of
a bundle is the port's device plane (``ops/backend.probe_snapshot``),
looked up by module name so a bundle never imports torch.
"""

from __future__ import annotations

import collections
import os
import sys
import tempfile
import threading
import time
import traceback
from typing import Any

import makisu_tpu_torch
from makisu_tpu_torch.utils import events
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

BUNDLE_SCHEMA = "makisu-tpu.flightrecorder.v1"
DEFAULT_EVENTS_KEEP = 256
DEFAULT_LOGS_KEEP = 64


def last_progress_seconds(cell: list | None = None) -> float:
    """Seconds since the last observable progress. With no ``cell``:
    process-wide — the newest of the event bus's last emit and the
    transfer engine's last completed work (the worker's ``/healthz``
    field and its process watchdog). With a per-build progress cell
    (``events.bind_progress_cell``): that build's own clock, so a
    wedged build's watchdog is not masked by healthy siblings."""
    if cell is not None:
        return max(time.monotonic() - cell[0], 0.0)
    marks = [events.last_emit_monotonic()]
    try:
        from makisu_tpu_torch.registry import transfer
        marks.append(transfer.last_progress_monotonic())
    except Exception:  # noqa: BLE001 - forensics never fails the caller
        pass
    return max(time.monotonic() - max(marks), 0.0)


def thread_stacks() -> list[dict]:
    """All-thread stack traces via ``sys._current_frames``, newest
    frame last (traceback order). Lock-free: safe from a signal
    handler."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(frames.items()):
        thread = by_ident.get(ident)
        # format_stack entries are "File ..., line N, in f\n    code";
        # flatten to one string per line so consumers (and doctor's
        # frame parser) never meet embedded newlines.
        stack = [line for entry in traceback.format_stack(frame)
                 for line in entry.rstrip("\n").split("\n")]
        out.append({
            "name": thread.name if thread else f"thread-{ident}",
            "ident": ident,
            "daemon": bool(thread.daemon) if thread else None,
            "stack": stack,
        })
    return out


def _transfer_state() -> dict | None:
    """The transfer engine's in-flight snapshot, or None when no
    transfer has ever run in this process."""
    try:
        from makisu_tpu_torch.registry import transfer
        engine = transfer.peek()
    except Exception:  # noqa: BLE001
        return None
    return engine.snapshot() if engine is not None else None


def _device_probe_state() -> dict | None:
    """The backend probe's phase/sample snapshot, or None when the
    device plane was never touched. Lock-free underneath
    (``ops/backend.py`` tracker stores are GIL-atomic), so safe from
    signal context; the ops package is only consulted when something
    already imported it — a bundle must not pay a torch import."""
    if "makisu_tpu_torch.ops.backend" not in sys.modules:
        return None
    try:
        return sys.modules["makisu_tpu_torch.ops.backend"].probe_snapshot()
    except Exception:  # noqa: BLE001 - forensics never fails the dump
        return None


def _metrics_snapshot(reg: "metrics.MetricsRegistry") -> dict | None:
    """``reg.report()`` guarded for signal context: if the interrupted
    main thread holds the registry lock the probe times out and the
    bundle ships without a metrics section instead of deadlocking."""
    if not reg._lock.acquire(timeout=0.5):
        return None
    reg._lock.release()  # report() re-acquires; probe proved it's free
    return reg.report()


def _bundle_name(reason: str, tag: str) -> str:
    """``tag`` (a truncated trace id) disambiguates concurrent builds
    in one worker PROCESS — without it, two builds failing seconds
    apart would resolve the same pid-keyed path and the second dump
    would silently replace the first build's forensics."""
    middle = f"{tag}-" if tag else ""
    return f"makisu-tpu-diag-{os.getpid()}-{middle}{reason}.json"


def resolve_bundle_path(diag_out: str, reason: str,
                        tag: str = "") -> str | None:
    """Where a bundle should land: an explicit ``--diag-out`` wins,
    then ``$MAKISU_TPU_DIAG_DIR`` (CI sets this so red runs upload the
    bundle as an artifact), else None — failure dumps are opt-in."""
    if diag_out:
        return diag_out
    diag_dir = os.environ.get("MAKISU_TPU_DIAG_DIR", "")
    if diag_dir:
        try:
            os.makedirs(diag_dir, exist_ok=True)
        except OSError:
            return None
        return os.path.join(diag_dir, _bundle_name(reason, tag))
    return None


def forced_bundle_path(diag_out: str, reason: str, tag: str = "") -> str:
    """Like :func:`resolve_bundle_path` but never None: stalls and
    signals always leave a bundle somewhere (the tempdir as a last
    resort) — those are exactly the deaths that otherwise leave no
    trace."""
    return (resolve_bundle_path(diag_out, reason, tag) or
            os.path.join(tempfile.gettempdir(),
                         _bundle_name(reason, tag)))


def forced_profile_path(diag_out: str, reason: str, tag: str = "") -> str:
    """Where an on-demand profile snapshot (SIGUSR2) lands: next to an
    explicit ``--diag-out`` bundle (never ON it — the profile must not
    clobber captured forensics), else ``$MAKISU_TPU_DIAG_DIR``, else
    the tempdir. Never None, same contract as
    :func:`forced_bundle_path`."""
    middle = f"{tag}-" if tag else ""
    name = f"makisu-tpu-profile-{os.getpid()}-{middle}{reason}.json"
    if diag_out:
        parent = os.path.dirname(diag_out) or "."
        try:
            os.makedirs(parent, exist_ok=True)
        except OSError:
            pass
        return os.path.join(parent, name)
    diag_dir = os.environ.get("MAKISU_TPU_DIAG_DIR", "")
    if diag_dir:
        try:
            os.makedirs(diag_dir, exist_ok=True)
            return os.path.join(diag_dir, name)
        except OSError:
            pass
    return os.path.join(tempfile.gettempdir(), name)


class FlightRecorder:
    """Bounded in-memory record of one build (or one process, when
    armed globally by the worker). All appends are lock-free deque
    writes; readers take snapshots with a retry so a dump racing an
    append can never block or corrupt."""

    def __init__(self, events_keep: int = DEFAULT_EVENTS_KEEP,
                 logs_keep: int = DEFAULT_LOGS_KEEP) -> None:
        self._events: "collections.deque[dict]" = \
            collections.deque(maxlen=events_keep)
        self._logs: "collections.deque[dict]" = \
            collections.deque(maxlen=logs_keep)
        self.armed_at = time.time()
        self.dumped = False
        self.dumped_reasons: set[str] = set()
        self.last_dump_path: str | None = None

    def captured_terminal_moment(self) -> bool:
        """Whether a dump already froze the INTERESTING moment — a
        stall or a kill signal. A SIGUSR1 inspection poke doesn't
        count: it must not suppress the eventual failure bundle."""
        return bool(self.dumped_reasons & {"stall", "SIGTERM"})

    # -- feeds ------------------------------------------------------------

    def record_event(self, event: dict) -> None:
        """Event-bus sink (bind with ``events.add_sink``)."""
        self._events.append(event)

    def record_log(self, level: str, msg: str, fields: dict) -> None:
        """Log tap (bind with ``logging.add_tap``)."""
        record = {"ts": round(time.time(), 6), "level": level, "msg": msg}
        if fields:
            record["fields"] = dict(fields)
        self._logs.append(record)

    @staticmethod
    def _snapshot(ring: "collections.deque[dict]") -> list[dict]:
        return metrics.snapshot_concurrent(ring)

    # -- bundles ----------------------------------------------------------

    def bundle(self, reason: str,
               registry: "metrics.MetricsRegistry | None" = None,
               **extra: Any) -> dict[str, Any]:
        """Assemble the diagnostic bundle. ``registry`` defaults to the
        context's active one — a watchdog running in the build's copied
        context or a signal handler in a standalone build both resolve
        to the build registry; the worker's process-level recorder
        resolves to the global one."""
        from makisu_tpu_torch.utils import resources
        reg = registry if registry is not None else \
            metrics.active_registry()
        open_spans = metrics.open_span_snapshot()
        if reg is not metrics.global_registry():
            # A per-build bundle must not blame another build: in a
            # worker the open-span set spans every registry, and the
            # doctor's stuck-span verdict would otherwise pick a
            # healthy sibling's long-running span. (Process-level
            # bundles — the worker's — keep the full view.)
            open_spans = [s for s in open_spans
                          if s["trace_id"] == reg.trace_id]
        out: dict[str, Any] = {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "ts": round(time.time(), 6),
            "build": {
                "trace_id": reg.trace_id,
                "pid": os.getpid(),
                "version": makisu_tpu_torch.__version__,
                "argv0": sys.argv[0] if sys.argv else "",
                "recorder_armed_at": round(self.armed_at, 6),
            },
            "last_progress_seconds": round(last_progress_seconds(), 3),
            "events": self._snapshot(self._events),
            "logs": self._snapshot(self._logs),
            "open_spans": open_spans,
            "threads": thread_stacks(),
            "transfer": _transfer_state(),
            "resources": resources.trajectory(),
            "device_probe": _device_probe_state(),
            "profile": _profile_tail(),
        }
        out["metrics"] = _metrics_snapshot(reg)
        out.update(extra)
        return out

    def dump(self, path: str, reason: str,
             registry: "metrics.MetricsRegistry | None" = None,
             **extra: Any) -> str:
        """Write the bundle atomically and remember that we did — a
        later generic failure dump must not overwrite the stacks a
        stall or SIGTERM captured at the interesting moment."""
        metrics.write_json_atomic(path,
                                  self.bundle(reason, registry, **extra))
        self.dumped = True
        self.dumped_reasons.add(reason)
        self.last_dump_path = path
        # The counter bump takes every target registry's non-reentrant
        # lock; from a signal handler the interrupted frame may HOLD
        # one. Probe each with a timeout and skip the counter rather
        # than deadlock the dying process (same discipline as
        # _metrics_snapshot).
        for reg in metrics._targets():
            if not reg._lock.acquire(timeout=0.2):
                break
            reg._lock.release()
        else:
            metrics.counter_add("makisu_diag_bundles_total",
                                reason=reason)
        return path


def _profile_tail(limit: int = 40) -> dict | None:
    """A trimmed snapshot of the process sampler for embedding in
    diagnostic bundles: the hottest ``limit`` folded stacks plus the
    sampler's vitals. None when no sampler is armed. Lock-free reads
    only — bundles are assembled from signal handlers."""
    from makisu_tpu_torch.utils import profiler
    sampler = profiler.process_profiler()
    if sampler is None or not sampler.samples_total:
        return None
    doc = sampler.snapshot()
    doc["stacks"] = doc["stacks"][:limit]
    doc.pop("traces", None)
    return doc


def install(recorder: FlightRecorder) -> tuple:
    """Bind a recorder to the current context's event bus and log tap.
    Returns tokens for :func:`uninstall`."""
    return (events.add_sink(recorder.record_event),
            log.add_tap(recorder.record_log))


def uninstall(tokens: tuple) -> None:
    events_token, log_token = tokens
    log.reset_tap(log_token)
    events.reset_sink(events_token)


def install_signal_dumps(recorder: FlightRecorder,
                         registry: "metrics.MetricsRegistry | None",
                         diag_out: str, tag: str = "") -> dict:
    """Bind SIGTERM (dump, then unwind via ``SystemExit(143)`` so open
    reports/logs still flush), SIGUSR1 (dump and keep running — live
    inspection), and SIGUSR2 (write the process sampler's profile
    snapshot and keep running — on-demand "where is the time going"
    without stopping the build) to ``recorder``. Main thread only —
    elsewhere (worker build handler threads) this is a no-op. Returns
    the replaced handlers for :func:`restore_signal_handlers`."""
    import signal
    old: dict = {}
    if threading.current_thread() is not threading.main_thread():
        return old

    def _dump(signum, frame, exit_after):
        name = signal.Signals(signum).name
        try:
            recorder.dump(forced_bundle_path(diag_out, name, tag=tag),
                          name, registry)
        except Exception:  # noqa: BLE001 - dying is the priority
            pass
        if exit_after:
            raise SystemExit(128 + signum)

    def _profile_dump(signum, frame):
        # Resolved at fire time, not registration time: the worker
        # arms its sampler after installing handlers, and a build with
        # --profile-hz 0 simply has nothing to dump.
        from makisu_tpu_torch.utils import profiler
        name = signal.Signals(signum).name
        sampler = profiler.process_profiler()
        if sampler is None:
            return
        try:
            profiler.write_artifact(
                forced_profile_path(diag_out, name, tag=tag),
                sampler.snapshot(command=name))
        except Exception as e:  # noqa: BLE001 - forensics never kills work
            # Signal context: the logging plane takes sink locks, so
            # the trace goes straight to fd 2 (async-signal-safe).
            try:
                os.write(2, f"{name} profile dump failed: {e}\n".encode())
            except OSError:
                pass

    for sig, exit_after in ((signal.SIGTERM, True),
                            (signal.SIGUSR1, False)):
        try:
            old[sig] = signal.signal(
                sig, lambda s, f, e=exit_after: _dump(s, f, e))
        except (ValueError, OSError):  # pragma: no cover
            pass
    try:
        old[signal.SIGUSR2] = signal.signal(signal.SIGUSR2,
                                            _profile_dump)
    except (ValueError, OSError):  # pragma: no cover
        pass
    return old


def restore_signal_handlers(old: dict) -> None:
    import signal
    for sig, handler in old.items():
        try:
            signal.signal(sig, handler)
        except (ValueError, OSError):  # pragma: no cover
            pass


class StallWatchdog:
    """Fires when the build makes no observable progress for ``window``
    seconds: emits a ``stall`` event (into the build's own event sinks —
    the thread runs under the creator's copied context, so the event
    also lands in ``--events-out``), snapshots thread stacks into a
    bundle, and publishes ``makisu_build_stalled``. Re-arms once
    progress resumes, so a build that stalls twice dumps twice (the
    second dump overwrites — latest wedge wins)."""

    def __init__(self, window: float, recorder: FlightRecorder,
                 bundle_path: str,
                 registry: "metrics.MetricsRegistry | None" = None,
                 active_fn=None,
                 cell: list | None = None) -> None:
        self.window = max(float(window), 0.1)
        self.recorder = recorder
        self.bundle_path = bundle_path
        self.registry = registry
        # Gate: only consider idleness a stall while work is actually
        # in flight. A per-build watchdog is always "active" (a build
        # is by definition running); the worker's process watchdog
        # passes active_builds > 0 so an idle worker never dumps.
        self.active_fn = active_fn
        # Per-build progress cell (events.bind_progress_cell): this
        # watchdog watches ONE build's clock. None = process-wide.
        self.cell = cell
        self._stop = threading.Event()
        self._fired = False
        self._thread: threading.Thread | None = None

    def _set_stalled(self, value: float) -> None:
        # Per-build watchdogs label their series by trace id so
        # concurrent watchdogs in one worker can't overwrite each
        # other; the process watchdog owns the unlabeled series.
        labels = ({"trace_id": self.registry.trace_id}
                  if self.cell is not None and self.registry is not None
                  else {})
        metrics.global_registry().gauge_set("makisu_build_stalled",
                                            value, **labels)

    def _tick(self) -> None:
        if self.active_fn is not None and not self.active_fn():
            self._fired = False
            self._set_stalled(0.0)
            return
        idle = last_progress_seconds(self.cell)
        self._set_stalled(1.0 if idle >= self.window else 0.0)
        if idle < self.window:
            self._fired = False
            return
        if self._fired:
            return
        self._fired = True
        events.emit("stall", idle_seconds=round(idle, 3),
                    window_seconds=self.window)
        metrics.counter_add("makisu_stalls_total")
        try:
            # The stall emit itself just stamped the progress clock;
            # the bundle must carry the idle gap that TRIGGERED it.
            self.recorder.dump(self.bundle_path, "stall", self.registry,
                               last_progress_seconds=round(idle, 3))
            log.warning(
                "build stalled: no progress for %.1fs (window %.1fs); "
                "diagnostic bundle written to %s",
                idle, self.window, self.bundle_path)
        except Exception as e:  # noqa: BLE001 - forensics never kills a build
            log.warning("stall bundle write failed: %s", e)

    def _run(self) -> None:
        # This thread's emits/logs (the stall event, the bundle-written
        # warning) must not stamp the progress clock it polls — a
        # permanent wedge fires ONCE and last_progress_seconds keeps
        # climbing for /healthz.
        events.suppress_progress_stamps()
        interval = min(max(self.window / 4.0, 0.05), 5.0)
        while not self._stop.wait(interval):
            try:
                self._tick()
            except Exception:  # noqa: BLE001
                pass

    def start(self) -> "StallWatchdog":
        import contextvars
        # Copy the creator's context so stall events reach the build's
        # own sinks (events-out file, worker stream, recorder).
        ctx = contextvars.copy_context()
        self._thread = threading.Thread(
            target=ctx.run, args=(self._run,),
            name="stall-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        # Clear our gauge series: a long-lived worker must not report
        # a finished build as stalled forever.
        self._set_stalled(0.0)


def stall_timeout_from_env() -> float:
    """``MAKISU_TPU_STALL_TIMEOUT`` seconds; 0/unset/garbage = off."""
    try:
        return max(float(os.environ.get(
            "MAKISU_TPU_STALL_TIMEOUT", "") or 0.0), 0.0)
    except ValueError:
        return 0.0


# -- `makisu-tpu doctor` ----------------------------------------------------


def _fmt_bytes(n: float) -> str:
    from makisu_tpu_torch.utils import traceexport
    return traceexport.fmt_bytes(n)


# Threads that exist BECAUSE of the forensics layer; never the wedge.
_FORENSIC_THREADS = ("stall-watchdog", "resource-sampler",
                     "profiler-sampler")
_FORENSIC_FILES = ("flightrecorder.py", "resources.py", "profiler.py")
# A frame of either builder package is project work: "makisu_tpu" is a
# prefix of both package directories (makisu_tpu/, makisu_tpu_torch/),
# so this package's doctor and the reference's find the same busy
# threads in a bundle of either.
_PROJECT_FRAME = "makisu_tpu"


def _thread_busy(thread: dict) -> bool:
    """A thread is interesting when any frame of its stack is in
    makisu-tpu code: a parked pool worker shows only stdlib plumbing
    (queue.get, Condition.wait), while a thread wedged mid-transfer
    has project frames above its blocking stdlib call — the innermost
    frame alone cannot tell them apart. The forensics layer's own
    frames (the thread doing the dump) don't count as work."""
    if thread.get("name") in _FORENSIC_THREADS:
        return False
    return any(_PROJECT_FRAME in line
               and not any(f in line for f in _FORENSIC_FILES)
               for line in thread["stack"])


def _innermost(stack: list[str], skip_forensics: bool = False) -> str:
    """'func (file:line)' of a formatted stack's deepest frame.
    ``skip_forensics`` skips the dump machinery's own frames — a
    SIGTERM handler's MainThread stack ends inside the recorder, but
    the wedge is the frame below it."""
    for line in reversed(stack):
        line = line.strip()
        if not line.startswith("File "):
            continue
        if skip_forensics and any(f in line for f in _FORENSIC_FILES):
            continue
        try:
            path, lineno, func = line.split(", ", 2)
            name = os.path.basename(path.split('"')[1])
            return (f"{func.removeprefix('in ')} "
                    f"({name}:{lineno.removeprefix('line ')})")
        except (IndexError, ValueError):
            return line
    return stack[-1].strip() if stack else "?"


def render_doctor(bundle: dict) -> str:
    """Human diagnosis of a diagnostic bundle: what was stuck, which
    threads were wedged where, and how resources were trending when
    the build died."""
    lines: list[str] = []
    build = bundle.get("build", {})
    reason = bundle.get("reason", "?")
    ts = bundle.get("ts")
    when = (time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime(ts))
            if ts else "?")
    lines.append(f"makisu-tpu doctor — bundle reason: {reason}")
    lines.append(f"captured: {when}  pid: {build.get('pid', '?')}  "
                 f"version: {build.get('version', '?')}")
    if build.get("trace_id"):
        lines.append(f"trace id: {build['trace_id']}")
    idle = bundle.get("last_progress_seconds")
    if idle is not None:
        lines.append(f"last progress: {idle:.1f}s before capture")

    # -- stuck spans ------------------------------------------------------
    open_spans = bundle.get("open_spans") or []
    lines.append("")
    diagnosis: list[str] = []
    if open_spans:
        lines.append(f"open spans at capture ({len(open_spans)}):")
        for span in open_spans:
            attrs = span.get("attrs") or {}
            detail = ", ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
            label = span["name"] + (f" [{detail}]" if detail else "")
            leaf = " ◀ stuck here" if span.get("leaf") else ""
            lines.append(f"  {label:<44s} open "
                         f"{span.get('age_seconds', 0.0):8.1f}s{leaf}")
        leaves = [s for s in open_spans if s.get("leaf")]
        pick = max(leaves or open_spans,
                   key=lambda s: s.get("age_seconds", 0.0))
        diagnosis.append(
            f"build appears stuck in span '{pick['name']}' "
            f"(open {pick.get('age_seconds', 0.0):.1f}s)")
    else:
        lines.append("no spans were open at capture (the build was "
                     "between operations, or telemetry was torn down)")

    # -- threads ----------------------------------------------------------
    threads = bundle.get("threads") or []
    busy = [t for t in threads if _thread_busy(t)]
    lines.append("")
    lines.append(f"threads: {len(threads)} total, "
                 f"{len(busy)} with makisu-tpu frames")
    for t in threads[:16]:
        marker = "  ◀ busy" if t in busy else ""
        lines.append(f"  {t['name']:<24s} "
                     f"{_innermost(t['stack'])}{marker}")
    if len(threads) > 16:
        lines.append(f"  ... and {len(threads) - 16} more")
    for t in busy[:4]:
        lines.append("")
        lines.append(f"  stack of {t['name']}:")
        for frame in t["stack"][-8:]:
            lines.append(f"    {frame.strip()}")
    # A wedged-thread verdict only makes sense when the capture froze a
    # LIVE wedge (stall/signal); a failure bundle's stacks are post-hoc
    # — the build already unwound to the dump site.
    if busy and reason != "failure":
        wedge = next((t for t in busy if t["name"] != "MainThread"),
                     busy[0])
        diagnosis.append(
            f"thread '{wedge['name']}' wedged in "
            f"{_innermost(wedge['stack'], skip_forensics=True)}")

    # -- transfer engine --------------------------------------------------
    transfer = bundle.get("transfer")
    lines.append("")
    if transfer:
        lines.append(
            f"transfer engine: {transfer.get('queue_depth', 0)} tasks "
            f"in flight, "
            f"{_fmt_bytes(transfer.get('inflight_bytes', 0))} of "
            f"{_fmt_bytes(transfer.get('budget_limit_bytes', 0))} "
            f"budget reserved, concurrency "
            f"{transfer.get('concurrency', '?')}")
        if transfer.get("queue_depth", 0) > 0:
            diagnosis.append(
                f"{transfer['queue_depth']} transfer task(s) never "
                f"completed — suspect a wedged registry connection")
    else:
        lines.append("transfer engine: never used in this process")

    # -- device probe -----------------------------------------------------
    probe = bundle.get("device_probe") or {}
    state = probe.get("state", "")
    if state and state not in ("absent", "disabled"):
        lines.append("")
        desc = f"device probe: {state}"
        if probe.get("phase"):
            desc += f", in phase '{probe['phase']}'"
        elif probe.get("phase_reached"):
            desc += f", reached '{probe['phase_reached']}'"
        if probe.get("elapsed_seconds") is not None:
            desc += f", {probe['elapsed_seconds']:.0f}s elapsed"
        if probe.get("sample_count"):
            desc += f", {probe['sample_count']} stack samples"
        lines.append(desc)
        if probe.get("deepest_frame"):
            lines.append(f"  deepest sampled frame: "
                         f"{probe['deepest_frame']}")
        if state in ("wedged", "pending") and probe.get("phase"):
            diagnosis.append(
                f"backend init {state} in probe phase "
                f"'{probe['phase']}'"
                + (f" at {probe['deepest_frame']}"
                   if probe.get("deepest_frame") else ""))
        elif state == "failed" and probe.get("detail"):
            diagnosis.append(
                f"backend init failed: {probe['detail'][:120]}")

    # -- continuous profile -----------------------------------------------
    prof = bundle.get("profile") or {}
    if prof.get("samples"):
        from makisu_tpu_torch.utils import profiler
        total = prof["samples"]
        lines.append("")
        lines.append(
            f"profile: {total} samples over "
            f"{prof.get('duration_seconds', 0.0):.1f}s at "
            f"{prof.get('hz', 0.0):g} Hz, sampler overhead "
            f"{100.0 * prof.get('overhead_fraction', 0.0):.2f}%")
        phases = prof.get("phases") or {}
        for phase, count in sorted(phases.items(),
                                   key=lambda kv: -kv[1])[:5]:
            hot = profiler.dominant_frame(prof, phase)
            detail = (f" — hottest frame {hot[0]} ({hot[1]} samples)"
                      if hot else "")
            lines.append(f"  {phase:<6s} {100.0 * count / total:5.1f}%"
                         f"{detail}")
        # A phase that owns most of the wall clock gets its hottest
        # frame named in the verdict — the attribution `history diff`
        # and SLO alerts can only gesture at.
        top_phase, top_count = max(phases.items(),
                                   key=lambda kv: kv[1],
                                   default=("", 0))
        hot = profiler.dominant_frame(prof, top_phase) \
            if top_phase else None
        if hot and top_count / total >= 0.5:
            diagnosis.append(
                f"phase '{top_phase}' dominates the profile "
                f"({100.0 * top_count / total:.0f}% of samples), "
                f"mostly in {hot[0]}")

    # -- resources --------------------------------------------------------
    samples = bundle.get("resources") or []
    lines.append("")
    if samples:
        first, last = samples[0], samples[-1]
        peak = max(s.get("rss_bytes", 0) for s in samples)
        lines.append(
            f"resources ({len(samples)} samples): rss "
            f"{_fmt_bytes(first.get('rss_bytes', 0))} → peak "
            f"{_fmt_bytes(peak)} → {_fmt_bytes(last.get('rss_bytes', 0))}"
            f", cpu {last.get('cpu_seconds', 0.0):.1f}s"
            + (f", {last['open_fds']} open fds"
               if "open_fds" in last else ""))
        if (last.get("rss_bytes", 0) > 0.9 * peak and
                peak > 2 * max(first.get("rss_bytes", 0), 1)):
            diagnosis.append("RSS was climbing at capture — possible "
                             "memory exhaustion")
    else:
        lines.append("resources: no samples recorded")

    # -- recent events ----------------------------------------------------
    tail = (bundle.get("events") or [])[-8:]
    if tail:
        lines.append("")
        lines.append(f"last {len(tail)} events:")
        base = tail[-1].get("ts", 0.0)
        for event in tail:
            extras = {k: v for k, v in event.items()
                      if k not in ("ts", "type")}
            detail = " ".join(f"{k}={v}" for k, v in sorted(extras.items()))
            dt = event.get("ts", 0.0) - base
            lines.append(f"  {dt:+8.2f}s  {event.get('type', '?'):<12s} "
                         f"{detail}"[:100])

    lines.append("")
    if diagnosis:
        lines.append("diagnosis: " + "; ".join(diagnosis) + ".")
    else:
        lines.append("diagnosis: nothing conclusive — the process was "
                     "idle and consistent at capture; check the event "
                     "tail and logs above for the last thing it did.")
    return "\n".join(lines) + "\n"
