"""Continuous wall-clock sampling profiler: where the time actually went.

Every attribution layer so far works from *declared* timing — spans
the code chose to open, stage busy-counters the commit pipeline chose
to bump. The gap: when `history diff` or an SLO burn alert says a
build got slower, nothing names the *frames* responsible, and the
~1.15s warm-resident floor is opaque below the span level. This module
is the attribution tool:

- :class:`SamplingProfiler` — a daemon thread walking
  ``sys._current_frames()`` at ``--profile-hz`` (default ~67 Hz,
  ``MAKISU_TPU_PROFILE_HZ``, 0 = off), folding each working thread's
  stack into bounded collapsed-stack counts tagged with the owning
  build's trace id and current phase (joined through the open-span
  plane + ``traceexport.phase_of``). Parked stdlib threads (pool
  workers idling in ``threading.py`` waits) and the forensics layer's
  own threads are excluded — the same representative-frame discipline
  the device-probe watcher uses.
- Self-measured overhead: every sampling pass is timed, the cumulative
  cost over wall time is exported (``makisu_profiler_overhead_ratio``)
  and governed — when a pass costs more than the budget (default 2%)
  allows at the configured rate, the sampler stretches its sleep
  instead of lying about its cost.
- ``makisu-tpu.profile.v1`` artifacts: folded stacks plus an embedded
  speedscope-compatible sampled profile (drop into speedscope.app),
  written with ``--profile-out``, ``SIGUSR2``, the worker's
  ``GET /profile?seconds=N``, and the fleet front door's merged
  cross-worker aggregation.
- :func:`diff` — differential profiles: which frames' self-time SHARE
  grew between two artifacts (the question behind every latency
  regression), with the `history diff` exit-code contract (1 = flagged).

Like the rest of the telemetry layer: stdlib-only, lock-free where a
signal handler can reach it (snapshot reads are retry-reads of
GIL-atomic dicts), and never able to fail a build.

Copy of ``makisu_tpu/utils/profiler.py``. The process profiler slot
and the thread bindings are this package's own.
"""

from __future__ import annotations

import html as html_mod
import os
import sys
import threading
import time
from typing import Any

from makisu_tpu_torch.utils import events, logging as log, metrics

PROFILE_SCHEMA = "makisu-tpu.profile.v1"

# ~67 Hz: prime-ish and off the 10ms/100ms beat of most sleep loops,
# so periodic work can't hide between samples (lockstep aliasing).
DEFAULT_HZ = 67.0

# Bounded memory: distinct folded-stack keys per profile. Stack-shape
# churn past the cap increments `dropped` instead of growing the dict.
DEFAULT_MAX_STACKS = 8192

# Distinct trace ids tallied before new ones collapse into "" — a
# long-lived worker mints one per build and must not grow unbounded.
_MAX_TRACES = 256

# Self-imposed overhead ceiling: the fraction of wall time the sampler
# may spend sampling before it stretches its own interval.
DEFAULT_BUDGET = 0.02

_STACK_DEPTH = 48

# Frames that are the interpreter's parking lot, not a location —
# Event/Condition waits, queue gets, selector polls, the pool-worker
# dispatch loop. A thread whose innermost frames are all parking is
# trimmed down to its first real frame (the representative-frame
# discipline from ops/backend.py); a thread that is NOTHING but
# parking frames is an idle pool/server thread and contributes no
# samples. Build threads blocked inside these waits still count —
# trimmed to the project frame doing the waiting — because wall-clock
# time spent blocked IS build latency.
_PARKING_FILES = ("threading.py", "queue.py", "selectors.py",
                  "socketserver.py", "thread.py")
_SELF_FILES = ("profiler.py",)

# Threads that exist BECAUSE of the telemetry/forensics layer: never
# build work, never sampled.
_FORENSIC_THREADS = ("profiler-sampler", "stall-watchdog",
                     "resource-sampler", "slo-evaluator",
                     "canary-driver")


def resolve_hz(flag: float | None = None) -> float:
    """The sampling rate this process should run: an explicit
    ``--profile-hz`` wins, else ``MAKISU_TPU_PROFILE_HZ``, else the
    always-on default. 0 (or garbage) anywhere in the chain = off."""
    if flag is not None:
        return max(float(flag), 0.0)
    raw = os.environ.get("MAKISU_TPU_PROFILE_HZ", "")
    if raw:
        try:
            return max(float(raw), 0.0)
        except ValueError:
            return 0.0
    return DEFAULT_HZ


# -- thread → trace binding --------------------------------------------------

# Which build each thread is working for: cli.main binds its invocation
# thread to its registry's trace id, so a worker running N concurrent
# builds attributes each handler thread's samples to the right build.
# Unbound threads (pipeline pool workers) fall back to the sole active
# trace when only one build is in flight, else to stack-shape phase
# inference. GIL-atomic dict ops only — the sampler reads it lock-free.
_thread_traces: dict[int, str] = {}


def bind_thread(trace_id: str):
    """Tag the CURRENT thread's samples with ``trace_id``. Returns a
    token for :func:`unbind_thread`."""
    ident = threading.get_ident()
    token = (ident, _thread_traces.get(ident))
    _thread_traces[ident] = trace_id
    return token


def unbind_thread(token) -> None:
    ident, prev = token
    if prev is None:
        _thread_traces.pop(ident, None)
    else:
        _thread_traces[ident] = prev


# -- the process profiler registry -------------------------------------------

# One sampler per process: the worker arms it for its lifetime; a
# standalone cli.main arms one per invocation only when no process-
# level sampler already covers it (a build inside a worker must not
# double-sample).
_process_profiler: "SamplingProfiler | None" = None


def set_process_profiler(p: "SamplingProfiler | None") -> None:
    global _process_profiler
    _process_profiler = p


def process_profiler() -> "SamplingProfiler | None":
    return _process_profiler


# -- sampling ----------------------------------------------------------------


def _frame_label(code, lineno: int | None = None) -> str:
    base = os.path.basename(code.co_filename)
    return f"{code.co_name} ({base})"


def _fold_stack(frame) -> tuple[list[str], bool]:
    """Walk one thread's frame chain innermost→outermost into
    root-first labels. Returns ``(labels, working)``: consecutive
    innermost parking frames and the profiler's own frames are
    trimmed, and ``working`` is False when nothing but parking
    plumbing remains — an idle pool/server thread, not build work."""
    inner: list[str] = []
    working = False
    f = frame
    while f is not None and len(inner) < _STACK_DEPTH:
        code = f.f_code
        base = os.path.basename(code.co_filename)
        if not inner and base in _PARKING_FILES + _SELF_FILES:
            f = f.f_back
            continue  # still trimming the parked/self leaf
        inner.append(f"{code.co_name} ({base})")
        if base not in _PARKING_FILES + _SELF_FILES:
            working = True
        f = f.f_back
    inner.reverse()
    return inner, working


def _phase_from_stack(labels: list[str]) -> str:
    """Fallback phase attribution from the stack itself: the innermost
    frame whose name matches a phase rule (commit pipeline workers are
    unbound threads, but their function/file names carry the phase)."""
    from makisu_tpu_torch.utils import traceexport
    for label in reversed(labels):
        phase = traceexport.phase_of(label)
        if phase != "other":
            return phase
    return "other"


def _open_phases() -> dict[str, str]:
    """Current phase per trace id from the open-span plane: the
    LATEST-started open leaf span names where each build is right
    now, mapped through ``traceexport.phase_of``."""
    from makisu_tpu_torch.utils import traceexport
    best: dict[str, tuple[float, str]] = {}
    for span in metrics.open_span_snapshot():
        if not span.get("leaf"):
            continue
        tid = span.get("trace_id") or ""
        start = float(span.get("start") or 0.0)
        if tid not in best or start >= best[tid][0]:
            best[tid] = (start, span.get("name", ""))
    return {tid: traceexport.phase_of(name)
            for tid, (_start, name) in best.items()}


class SamplingProfiler:
    """The always-on wall-clock sampler. ``start`` spawns the daemon
    thread; every read path (``stats``, ``snapshot``, ``window``) is a
    lock-free retry-read, safe from signal handlers and HTTP handler
    threads while sampling continues."""

    def __init__(self, hz: float = DEFAULT_HZ,
                 max_stacks: int = DEFAULT_MAX_STACKS,
                 budget: float = DEFAULT_BUDGET) -> None:
        self.hz = max(float(hz), 0.0)
        self.max_stacks = max(int(max_stacks), 16)
        self.budget = max(float(budget), 0.001)
        # Mutated ONLY by the sampler thread; GIL-atomic ops so readers
        # take consistent-enough snapshots without a lock.
        self._stacks: dict[tuple[str, str], int] = {}
        self._phases: dict[str, int] = {}
        self._traces: dict[str, int] = {}
        self.samples_total = 0
        self.passes = 0
        self.dropped = 0
        self.throttled = 0
        self.cost_seconds = 0.0
        self.started_mono: float | None = None
        self.started_ts: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle --------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.hz > 0 and self._thread is not None

    def start(self) -> "SamplingProfiler":
        if self.hz <= 0 or self._thread is not None:
            return self
        self.started_mono = time.monotonic()
        self.started_ts = time.time()
        # Process-level sampling thread: must not pin any build's
        # registry/log context.  # check: allow(ctx-propagation)
        self._thread = threading.Thread(
            target=self._run, name="profiler-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- the sampling loop ------------------------------------------------

    def _run(self) -> None:
        # The sampler's own activity must not stamp the progress clock
        # the stall watchdog polls — sampling is observation, not work.
        events.suppress_progress_stamps()
        interval = 1.0 / self.hz
        next_metrics = 0.0
        while not self._stop.is_set():
            t0 = time.monotonic()
            # Cost is the sampler thread's own CPU time, not wall
            # time: under GIL contention a pass can WAIT a long time
            # while imposing almost nothing — throttling on wall time
            # would starve the sampler exactly when the process is
            # busiest (the moment profiles matter).
            c0 = time.thread_time()
            try:
                self._sample_once()
            except Exception as e:  # noqa: BLE001 - observation never kills work
                self.dropped += 1
                log.debug("sampler pass failed: %s", e)
            cost = time.thread_time() - c0
            self.cost_seconds += cost
            self.passes += 1
            if t0 >= next_metrics:
                self._export_metrics()
                next_metrics = t0 + 1.0
            # Overhead governor: a pass that cost more than the budget
            # allows at the nominal rate stretches THIS sleep so the
            # cumulative overhead fraction converges under the budget.
            sleep = interval
            floor = cost / self.budget
            if floor > interval:
                sleep = floor
                self.throttled += 1
            self._stop.wait(sleep)

    def _sample_once(self) -> None:
        own = threading.get_ident()
        frames = sys._current_frames()
        forensic = {t.ident for t in threading.enumerate()
                    if t.name in _FORENSIC_THREADS
                    or t.name.startswith("profiler-")}
        phases = _open_phases()
        sole_trace = next(iter(phases)) if len(phases) == 1 else ""
        for ident, frame in frames.items():
            if ident == own or ident in forensic:
                continue
            labels, working = _fold_stack(frame)
            if not labels or not working:
                continue
            trace = _thread_traces.get(ident) or sole_trace
            phase = phases.get(trace) or _phase_from_stack(labels)
            self._count(";".join(labels), phase, trace)

    def _count(self, folded: str, phase: str, trace: str) -> None:
        key = (phase, folded)
        current = self._stacks.get(key)
        if current is None and len(self._stacks) >= self.max_stacks:
            self.dropped += 1
        else:
            self._stacks[key] = (current or 0) + 1
        self._phases[phase] = self._phases.get(phase, 0) + 1
        if trace not in self._traces and len(self._traces) >= _MAX_TRACES:
            trace = ""
        self._traces[trace] = self._traces.get(trace, 0) + 1
        self.samples_total += 1

    def _export_metrics(self) -> None:
        g = metrics.global_registry()
        g.gauge_set(metrics.PROFILER_SAMPLES, self.samples_total)
        g.gauge_set(metrics.PROFILER_DROPPED, self.dropped)
        g.gauge_set(metrics.PROFILER_STACKS, len(self._stacks))
        g.gauge_set(metrics.PROFILER_OVERHEAD, self.overhead_fraction())

    # -- reads ------------------------------------------------------------

    def overhead_fraction(self) -> float:
        if self.started_mono is None:
            return 0.0
        wall = max(time.monotonic() - self.started_mono, 1e-6)
        return min(self.cost_seconds / wall, 1.0)

    def stats(self) -> dict[str, Any]:
        """The worker ``/healthz`` ``profiler`` section: cheap, no
        stack serialization."""
        return {
            "enabled": self.enabled,
            "hz": self.hz,
            "samples_total": self.samples_total,
            "dropped": self.dropped,
            "throttled": self.throttled,
            "distinct_stacks": len(self._stacks),
            "overhead_fraction": round(self.overhead_fraction(), 5),
        }

    def snapshot(self, command: str = "") -> dict[str, Any]:
        """The full ``makisu-tpu.profile.v1`` document (sans the
        embedded speedscope export — :func:`write_artifact` adds it).
        Retry-reads, so callable while sampling continues and from
        signal context."""
        stacks = metrics.snapshot_concurrent(self._stacks.items())
        phases = dict(metrics.snapshot_concurrent(self._phases.items()))
        traces = dict(metrics.snapshot_concurrent(self._traces.items()))
        duration = (time.monotonic() - self.started_mono
                    if self.started_mono is not None else 0.0)
        return {
            "schema": PROFILE_SCHEMA,
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "command": command,
            "hz": self.hz,
            "duration_seconds": round(duration, 3),
            "samples": self.samples_total,
            "passes": self.passes,
            "dropped": self.dropped,
            "throttled": self.throttled,
            "overhead_fraction": round(self.overhead_fraction(), 5),
            "budget_fraction": self.budget,
            "phases": {k: v for k, v in sorted(phases.items())},
            "traces": {k: v for k, v in sorted(traces.items())},
            "stacks": sorted(
                ({"stack": folded, "phase": phase, "count": count}
                 for (phase, folded), count in stacks),
                key=lambda row: -row["count"]),
        }

    def window(self, seconds: float, command: str = "") -> dict[str, Any]:
        """An on-demand capture window (the worker's ``GET
        /profile?seconds=N``): the DELTA between two snapshots, so a
        long-lived process answers "what is it doing right now" rather
        than "what has it ever done". Blocks the calling thread for
        ``seconds``; sampling continues underneath."""
        before = self.snapshot(command)
        self._stop.wait(min(max(float(seconds), 0.1), 60.0))
        after = self.snapshot(command)
        return subtract(after, before)


# -- document algebra --------------------------------------------------------


def subtract(after: dict, before: dict) -> dict:
    """``after - before`` for two snapshots of ONE profiler: counts
    subtract, identity fields come from ``after``."""
    prior = {(row["phase"], row["stack"]): row["count"]
             for row in before.get("stacks") or []}
    stacks = []
    for row in after.get("stacks") or []:
        count = row["count"] - prior.get((row["phase"], row["stack"]), 0)
        if count > 0:
            stacks.append({"stack": row["stack"], "phase": row["phase"],
                           "count": count})
    out = dict(after)
    out["stacks"] = sorted(stacks, key=lambda r: -r["count"])
    out["samples"] = max(after.get("samples", 0)
                         - before.get("samples", 0), 0)
    out["passes"] = max(after.get("passes", 0)
                        - before.get("passes", 0), 0)
    out["dropped"] = max(after.get("dropped", 0)
                         - before.get("dropped", 0), 0)
    out["duration_seconds"] = round(max(
        after.get("duration_seconds", 0.0)
        - before.get("duration_seconds", 0.0), 0.0), 3)
    for field in ("phases", "traces"):
        prior_map = before.get(field) or {}
        merged = {}
        for key, value in (after.get(field) or {}).items():
            delta = value - prior_map.get(key, 0)
            if delta > 0:
                merged[key] = delta
        out[field] = merged
    return out


def merge_profiles(docs: dict[str, dict]) -> dict:
    """Fleet aggregation: merge per-worker profile documents into one
    (stack counts sum; per-worker vitals kept in ``workers``)."""
    stacks: dict[tuple[str, str], int] = {}
    phases: dict[str, int] = {}
    traces: dict[str, int] = {}
    workers: dict[str, dict] = {}
    samples = dropped = 0
    duration = 0.0
    hz = 0.0
    for worker_id, doc in sorted(docs.items()):
        for row in doc.get("stacks") or []:
            key = (row.get("phase", "other"), row.get("stack", ""))
            stacks[key] = stacks.get(key, 0) + int(row.get("count", 0))
        for phase, count in (doc.get("phases") or {}).items():
            phases[phase] = phases.get(phase, 0) + int(count)
        for tid, count in (doc.get("traces") or {}).items():
            traces[tid] = traces.get(tid, 0) + int(count)
        samples += int(doc.get("samples", 0))
        dropped += int(doc.get("dropped", 0))
        duration = max(duration, float(doc.get("duration_seconds", 0.0)))
        hz = max(hz, float(doc.get("hz", 0.0)))
        workers[worker_id] = {
            "samples": int(doc.get("samples", 0)),
            "hz": float(doc.get("hz", 0.0)),
            "overhead_fraction": float(doc.get("overhead_fraction",
                                               0.0)),
            "dropped": int(doc.get("dropped", 0)),
        }
    rows = sorted(({"stack": folded, "phase": phase, "count": count}
                   for (phase, folded), count in stacks.items()),
                  key=lambda r: -r["count"])
    if len(rows) > DEFAULT_MAX_STACKS:
        dropped += sum(r["count"] for r in rows[DEFAULT_MAX_STACKS:])
        rows = rows[:DEFAULT_MAX_STACKS]
    return {
        "schema": PROFILE_SCHEMA,
        "ts": round(time.time(), 3),
        "pid": 0,
        "command": "fleet",
        "hz": hz,
        "duration_seconds": round(duration, 3),
        "samples": samples,
        "dropped": dropped,
        "overhead_fraction": max(
            (w["overhead_fraction"] for w in workers.values()),
            default=0.0),
        "phases": {k: v for k, v in sorted(phases.items())},
        "traces": {k: v for k, v in sorted(traces.items())},
        "stacks": rows,
        "workers": workers,
    }


def self_time_by_frame(doc: dict) -> dict[str, int]:
    """Samples per LEAF frame — the folded stack's innermost entry
    owns the sample (self time), the collapsed-stack convention."""
    out: dict[str, int] = {}
    for row in doc.get("stacks") or []:
        frames = row.get("stack", "").split(";")
        if not frames or not frames[-1]:
            continue
        out[frames[-1]] = out.get(frames[-1], 0) + int(row.get("count",
                                                               0))
    return out


def frames_by_phase(doc: dict) -> dict[str, dict[str, int]]:
    """Self-time frames bucketed by attributed phase."""
    out: dict[str, dict[str, int]] = {}
    for row in doc.get("stacks") or []:
        frames = row.get("stack", "").split(";")
        if not frames or not frames[-1]:
            continue
        bucket = out.setdefault(row.get("phase", "other"), {})
        bucket[frames[-1]] = bucket.get(frames[-1], 0) \
            + int(row.get("count", 0))
    return out


def dominant_frame(doc: dict, phase: str) -> tuple[str, int] | None:
    """The hottest self-time frame of one phase — what `doctor` names
    when a phase is slow."""
    bucket = frames_by_phase(doc).get(phase) or {}
    if not bucket:
        return None
    frame = max(sorted(bucket), key=lambda f: bucket[f])
    return frame, bucket[frame]


# -- artifacts ---------------------------------------------------------------


def speedscope_profile(doc: dict) -> dict:
    """A speedscope-compatible sampled profile of the folded stacks
    (one synthetic sample per count unit; weights carry the counts so
    the file stays small)."""
    frame_index: dict[str, int] = {}
    frames: list[dict] = []
    samples: list[list[int]] = []
    weights: list[int] = []
    for row in doc.get("stacks") or []:
        stack = []
        for label in row.get("stack", "").split(";"):
            if label not in frame_index:
                frame_index[label] = len(frames)
                frames.append({"name": label})
            stack.append(frame_index[label])
        samples.append(stack)
        weights.append(int(row.get("count", 0)))
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": f"makisu-tpu {doc.get('command', '')} "
                    f"pid {doc.get('pid', '?')}".strip(),
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
        "name": "makisu-tpu profile",
        "activeProfileIndex": 0,
        "exporter": "makisu-tpu",
    }


def write_artifact(path: str, doc: dict) -> str:
    """Write the profile artifact (folded stacks + embedded speedscope
    export) atomically."""
    out = dict(doc)
    out["speedscope"] = speedscope_profile(doc)
    metrics.write_json_atomic(path, out)
    return path


def read_artifact(path: str) -> dict:
    """Load and validate a profile artifact. Raises ``ValueError`` on
    unreadable/wrong-schema input (the CLI maps it to exit 2, the
    `history diff` unreadable-input contract)."""
    import json
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise ValueError(f"unreadable profile {path}: {exc}") from exc
    if not isinstance(doc, dict) \
            or doc.get("schema") != PROFILE_SCHEMA:
        raise ValueError(
            f"{path} is not a {PROFILE_SCHEMA} artifact "
            f"(schema: {doc.get('schema') if isinstance(doc, dict) else '?'})")
    return doc


# -- differential profiles ---------------------------------------------------


def diff(baseline: dict, candidate: dict,
         threshold: float = 0.1) -> dict:
    """Attribute a regression to frames: for every frame, compare its
    self-time SHARE of total samples between the two profiles and flag
    growth beyond ``threshold`` (absolute share points as a fraction —
    0.1 flags a frame that grew from 2% to 13% of the build). Shares,
    not counts: the two captures may differ in duration and rate."""
    total_a = max(sum(self_time_by_frame(baseline).values()), 0)
    total_b = max(sum(self_time_by_frame(candidate).values()), 0)
    frames_a = self_time_by_frame(baseline)
    frames_b = self_time_by_frame(candidate)
    if not total_a or not total_b:
        return {"ok": True, "insufficient_samples": True,
                "threshold": threshold, "regressions": [],
                "baseline_samples": total_a,
                "candidate_samples": total_b, "phases": []}
    regressions: list[dict] = []
    for frame in sorted(set(frames_a) | set(frames_b)):
        share_a = frames_a.get(frame, 0) / total_a
        share_b = frames_b.get(frame, 0) / total_b
        growth = share_b - share_a
        if growth > threshold:
            regressions.append({
                "frame": frame,
                "baseline_share": round(share_a, 4),
                "candidate_share": round(share_b, 4),
                "growth": round(growth, 4),
            })
    regressions.sort(key=lambda r: -r["growth"])
    phase_rows: list[dict] = []
    pa = baseline.get("phases") or {}
    pb = candidate.get("phases") or {}
    sum_a = max(sum(pa.values()), 1)
    sum_b = max(sum(pb.values()), 1)
    for phase in sorted(set(pa) | set(pb)):
        phase_rows.append({
            "phase": phase,
            "baseline_share": round(pa.get(phase, 0) / sum_a, 4),
            "candidate_share": round(pb.get(phase, 0) / sum_b, 4),
        })
    return {
        "ok": not regressions,
        "threshold": threshold,
        "regressions": regressions,
        "baseline_samples": total_a,
        "candidate_samples": total_b,
        "phases": phase_rows,
    }


def render_diff(result: dict) -> str:
    """The ``makisu-tpu profile diff A B`` output."""
    lines = [
        "profile diff — baseline vs candidate "
        f"(threshold {100.0 * result['threshold']:.0f}% share growth)",
        f"  samples: {result['baseline_samples']} vs "
        f"{result['candidate_samples']}",
    ]
    if result.get("insufficient_samples"):
        lines.append("  one side has no samples — no signal, "
                     "not a regression")
        return "\n".join(lines) + "\n"
    moved = [row for row in result["phases"]
             if abs(row["candidate_share"] - row["baseline_share"])
             >= 0.01]
    for row in moved:
        lines.append(
            f"  phase {row['phase']:<6s} "
            f"{100.0 * row['baseline_share']:5.1f}% → "
            f"{100.0 * row['candidate_share']:5.1f}%")
    lines.append("")
    if result["regressions"]:
        lines.append(f"REGRESSION: {len(result['regressions'])} "
                     f"frame(s) grew beyond the threshold:")
        for r in result["regressions"][:10]:
            lines.append(
                f"  {r['frame']:<44s} "
                f"{100.0 * r['baseline_share']:5.1f}% → "
                f"{100.0 * r['candidate_share']:5.1f}%  "
                f"(+{100.0 * r['growth']:.1f} points)")
    else:
        lines.append("ok: no frame's self-time share grew beyond the "
                     "threshold")
    return "\n".join(lines) + "\n"


# -- renderers ---------------------------------------------------------------


def render_profile(doc: dict, top: int = 10) -> str:
    """The ``makisu-tpu profile ARTIFACT`` output: capture vitals, the
    phase-attributed breakdown, and top self-time frames (overall and
    per phase)."""
    from makisu_tpu_torch.utils import traceexport
    total = max(int(doc.get("samples", 0)), 0)
    lines = [
        f"makisu-tpu profile — {doc.get('command') or '?'}  "
        f"pid {doc.get('pid', '?')}",
        f"captured {doc.get('duration_seconds', 0.0):.1f}s at "
        f"{doc.get('hz', 0.0):g} Hz — {total} samples, "
        f"{len(doc.get('stacks') or [])} distinct stacks, "
        f"{doc.get('dropped', 0)} dropped",
        f"sampler overhead: "
        f"{100.0 * float(doc.get('overhead_fraction', 0.0)):.2f}% "
        f"of wall time (budget "
        f"{100.0 * float(doc.get('budget_fraction', DEFAULT_BUDGET)):.0f}%)",
    ]
    workers = doc.get("workers")
    if workers:
        lines.append(f"merged from {len(workers)} worker(s): " + "  ".join(
            f"{wid}={w['samples']}" for wid, w in sorted(workers.items())))
    phases = doc.get("phases") or {}
    if phases and total:
        lines.append("")
        lines.append("phase breakdown (sample share):")
        duration = float(doc.get("duration_seconds", 0.0))
        for phase in traceexport.PHASES:
            count = phases.get(phase, 0)
            if not count:
                continue
            share = count / total
            bar = "█" * max(int(share * 40), 1)
            est = f"  ~{share * duration:6.2f}s" if duration else ""
            lines.append(f"  {phase:<6s} {100.0 * share:5.1f}% "
                         f"{count:>7d}{est}  {bar}")
    frames = sorted(self_time_by_frame(doc).items(),
                    key=lambda kv: -kv[1])[:top]
    if frames and total:
        lines.append("")
        lines.append(f"top functions by self time (of {total} samples):")
        for frame, count in frames:
            lines.append(f"  {frame:<44s} {count:>7d} "
                         f"{100.0 * count / total:5.1f}%")
    by_phase = frames_by_phase(doc)
    hot = [(phase, sorted(bucket.items(), key=lambda kv: -kv[1])[0])
           for phase, bucket in sorted(by_phase.items()) if bucket]
    if hot and total:
        lines.append("")
        lines.append("dominant frame per phase:")
        for phase, (frame, count) in hot:
            lines.append(f"  {phase:<6s} {frame:<44s} {count:>7d}")
    traces = doc.get("traces") or {}
    named = {t: n for t, n in traces.items() if t}
    if len(named) > 1:
        lines.append("")
        lines.append(f"samples span {len(named)} builds (trace ids): "
                     + "  ".join(f"{t[:8]}={n}" for t, n in sorted(
                         named.items(), key=lambda kv: -kv[1])[:6]))
    return "\n".join(lines) + "\n"


_PHASE_COLORS = {
    "pull": "#4e79a7", "chunk": "#f28e2b", "hash": "#e15759",
    "push": "#76b7b2", "other": "#9c9c9c",
}


def _stack_tree(doc: dict) -> dict:
    root: dict = {"name": "all", "value": 0, "phase": "other",
                  "children": {}}
    for row in doc.get("stacks") or []:
        count = int(row.get("count", 0))
        phase = row.get("phase", "other")
        root["value"] += count
        node = root
        for label in row.get("stack", "").split(";"):
            child = node["children"].get(label)
            if child is None:
                child = {"name": label, "value": 0, "phase": phase,
                         "children": {}}
                node["children"][label] = child
            child["value"] += count
            node = child
    return root


def flamegraph_html(doc: dict, title: str = "") -> str:
    """A self-contained (no external assets) icicle/flamegraph HTML of
    the folded stacks, phase-colored, hover for counts."""
    root = _stack_tree(doc)
    total = max(root["value"], 1)

    def render(node: dict, share: float) -> str:
        pct = 100.0 * node["value"] / total
        color = _PHASE_COLORS.get(node.get("phase", "other"),
                                  "#9c9c9c")
        name = html_mod.escape(node["name"])
        tip = html_mod.escape(
            f"{node['name']} — {node['value']} samples ({pct:.1f}%)")
        kids = sorted(node["children"].values(),
                      key=lambda c: -c["value"])
        inner = "".join(
            render(child, 100.0 * child["value"] / node["value"])
            for child in kids if child["value"] / total >= 0.001)
        return (f'<div class="f" style="width:{share:.3f}%;'
                f'background:{color}" title="{tip}">'
                f'<span>{name}</span>'
                f'<div class="ch">{inner}</div></div>')

    body = render(root, 100.0)
    heading = html_mod.escape(
        title or f"makisu-tpu profile — {doc.get('command') or '?'} "
                 f"({doc.get('samples', 0)} samples)")
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{heading}</title>
<style>
body {{ font: 12px/1.4 system-ui, sans-serif; margin: 12px; }}
h1 {{ font-size: 14px; }}
.f {{ display: inline-block; vertical-align: top; overflow: hidden;
     box-sizing: border-box; border: 1px solid rgba(255,255,255,.6);
     border-radius: 2px; }}
.f > span {{ display: block; padding: 1px 3px; white-space: nowrap;
     overflow: hidden; text-overflow: ellipsis; color: #fff;
     font-size: 11px; }}
.ch {{ white-space: nowrap; width: 100%; }}
.legend span {{ display: inline-block; padding: 1px 8px; margin-right:
     6px; color: #fff; border-radius: 2px; font-size: 11px; }}
</style></head><body>
<h1>{heading}</h1>
<p class="legend">{"".join(
        f'<span style="background:{color}">{phase}</span>'
        for phase, color in _PHASE_COLORS.items())}</p>
<div style="white-space:nowrap">{body}</div>
</body></html>
"""
