"""Build event bus: the durable, streamable record of one build.

Spans (utils/metrics.py) answer "how long"; events answer "what
happened, in order, with what identity" — and unlike the span tree,
which only materializes when the build ends, events leave the process
the moment they occur. Three consumers:

- ``--events-out FILE``: a per-build JSONL event log (one JSON object
  per line), written through :class:`JsonlWriter`.
- The worker's ``/build`` response stream: each event rides as its own
  NDJSON frame (``{"event": {...}}``), interleaved with log-line
  frames, so a client watches a build's structure live.
- Tests/tools: any callable sink.

Scoping mirrors the per-build log sink in ``utils/logging.py`` and the
metrics contextvar: sinks bind to the current context, threads a build
spawns inherit them via ``contextvars.copy_context``, and concurrent
worker builds never see each other's events. With no sink bound,
``emit`` is a tuple-read no-op — instrumentation sites pay nothing.

Event shape: ``{"ts": <unix seconds>, "type": <str>, ...fields}``.
Types emitted today: ``build_start``/``build_end`` (cli.py),
``span_start``/``span_end`` (metrics.span), ``step`` (builder/stage.py,
``phase=start|done``), ``cache`` (cache/manager.py + cache/chunks.py,
``result=hit|miss|empty``), ``cache_decision`` (utils/ledger.py — the
cache-decision ledger's structured consult record), ``chunk_fetch``
(cache/chunks.py), and ``registry_blob`` (registry/client.py). The set
is open: any module may emit new types; consumers must ignore types
they don't know.

Like the rest of the telemetry layer: stdlib-only, import-cycle-free,
and never able to fail a build — a raising sink is swallowed (and
counted in ``makisu_events_dropped_total``, so a lossy event log is
detectable instead of silently incomplete).

Beyond the context-scoped sinks, two process-wide facilities ride on
``emit``:

- **global sinks** (:func:`add_global_sink`) see every context's
  events — the worker's process-level flight recorder uses this to
  keep a last-N ring across all builds it serves.
- **the progress clock**: every ``emit`` stamps a monotonic timestamp
  (:func:`last_emit_monotonic`) even when no sink is bound — one float
  store, the cheapest possible liveness signal. The stall watchdog
  (``utils/flightrecorder.py``) and the worker's ``/healthz``
  ``last_progress_seconds`` read it.

Copy of ``makisu_tpu/utils/events.py``. The bus, its sinks and the
progress cells are this package's own contextvars: a build of either
package never reaches the other's sinks.
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
from typing import Any, Callable

EventSink = Callable[[dict], None]

_sinks: "contextvars.ContextVar[tuple[EventSink, ...]]" = \
    contextvars.ContextVar("makisu_torch_event_sinks", default=())

# Process-wide sinks (worker flight recorder); mutated rarely, read on
# every emit. Kept as a tuple swapped whole so readers never see a
# half-updated list.
_global_sinks: tuple[EventSink, ...] = ()
_global_sinks_lock = threading.Lock()

# Monotonic timestamp of the last emit — the event bus's half of the
# build-progress clock (the transfer engine keeps the other half).
_last_emit = time.monotonic()


def last_emit_monotonic() -> float:
    """``time.monotonic()`` of the most recent :func:`emit` call (any
    context, sink bound or not) — or of an explicit
    :func:`note_progress` (the log path stamps it, so a build that
    logs without emitting events still reads as alive)."""
    return _last_emit


# Contexts whose activity must NOT count as build progress: the stall
# watchdog's own `stall` emit and warning log would otherwise reset the
# very clock it watches — one wedge would re-fire every window and
# /healthz's last_progress_seconds could never exceed it.
_suppress_progress: "contextvars.ContextVar[bool]" = \
    contextvars.ContextVar("makisu_torch_suppress_progress", default=False)


def suppress_progress_stamps():
    """Mark the current context (typically a forensics thread's copied
    context) as not-progress. Returns a reset token."""
    return _suppress_progress.set(True)


# Per-build progress cell: a one-element [monotonic] list bound in the
# build's context. copy_context shares the SAME list with every thread
# the build spawns, so all of a build's activity stamps one cell — and
# a per-build stall watchdog reads THAT cell instead of the process
# clock, which sibling builds in a worker keep fresh (a wedged build
# must not be masked by a healthy neighbor's progress).
_progress_cell: "contextvars.ContextVar[list[float] | None]" = \
    contextvars.ContextVar("makisu_torch_progress_cell", default=None)


def bind_progress_cell():
    """Bind a fresh per-build progress cell in the current context
    (``cli.main`` does this before spawning any build thread).
    Returns a reset token."""
    return _progress_cell.set([time.monotonic()])


def reset_progress_cell(token) -> None:
    _progress_cell.reset(token)


def progress_cell() -> list[float] | None:
    """The context's progress cell, if one is bound."""
    return _progress_cell.get()


def note_progress() -> None:
    """Stamp the progress clock(s) without emitting an event. Two
    float stores — cheap enough for any hot path that proves
    liveness."""
    if _suppress_progress.get():
        return
    global _last_emit
    _last_emit = time.monotonic()
    cell = _progress_cell.get()
    if cell is not None:
        cell[0] = _last_emit


def add_global_sink(sink: EventSink) -> None:
    """Register a process-wide sink that sees every context's events.
    Unlike context sinks this is not scoped — use for process-level
    consumers (the worker's flight recorder), and remove symmetrically
    with :func:`remove_global_sink`."""
    global _global_sinks
    with _global_sinks_lock:
        _global_sinks = _global_sinks + (sink,)


def remove_global_sink(sink: EventSink) -> None:
    global _global_sinks
    with _global_sinks_lock:
        # Equality, not identity: bound methods are recreated per
        # attribute access, and two equal bound methods name one sink.
        _global_sinks = tuple(s for s in _global_sinks if s != sink)


def add_sink(sink: EventSink):
    """Bind an event sink in the current context (stacking on any
    already bound). Returns a token for :func:`reset_sink`."""
    return _sinks.set(_sinks.get() + (sink,))


def reset_sink(token) -> None:
    _sinks.reset(token)


def active() -> bool:
    """Whether any sink (context or global) would receive an emit
    (lets callers skip building expensive event payloads)."""
    return bool(_sinks.get() or _global_sinks)


def emit(event_type: str, **fields: Any) -> None:
    """Deliver one event to every bound sink. No sink: free no-op
    (plus one float store for the progress clock). A sink that raises
    is ignored — events must never fail a build — but the drop is
    counted so consumers can tell their log is incomplete."""
    note_progress()
    sinks = _sinks.get() + _global_sinks
    if not sinks:
        return
    event: dict[str, Any] = {"ts": round(time.time(), 6),
                             "type": event_type}
    event.update(fields)
    _fan_out(event, sinks)


def deliver(event: dict) -> None:
    """Deliver a PRE-FORMED event (already carrying its own ``ts`` and
    ``type``) to every bound sink — the fleet front door uses this to
    tee a worker's streamed build events into its own event log
    without re-stamping them as if they happened here. Same progress
    stamp and swallow-and-count semantics as :func:`emit`."""
    note_progress()
    sinks = _sinks.get() + _global_sinks
    if sinks:
        _fan_out(event, sinks)


def _fan_out(event: dict, sinks: tuple[EventSink, ...]) -> None:
    for sink in sinks:
        try:
            sink(event)
        except Exception:  # noqa: BLE001 - a dead sink must not kill a build
            # Lazy import: metrics imports this module at its top.
            try:
                from makisu_tpu_torch.utils import metrics
                metrics.counter_add("makisu_events_dropped_total",
                                    event_type=event.get("type", "?"))
            except Exception:  # noqa: BLE001 - never recurse into failure
                pass


def promote_context_sinks() -> tuple[EventSink, ...]:
    """Re-register the current context's sinks as PROCESS-WIDE sinks
    and return them (for symmetric :func:`demote_sinks`). The fleet
    front door uses this: ``cli.main`` binds ``--events-out`` /
    ``--explain-out`` writers in the invocation's context, but the
    server's handler and poll threads have no bound context — without
    promotion, every front-door decision and span would silently miss
    the files the operator asked for."""
    sinks = _sinks.get()
    for sink in sinks:
        add_global_sink(sink)
    return sinks


def demote_sinks(sinks: tuple[EventSink, ...]) -> None:
    for sink in sinks:
        remove_global_sink(sink)


class JsonlWriter:
    """Append-only JSONL event sink (the ``--events-out`` file).

    Each event is one line, written and flushed under a lock so the
    concurrent writers a build spawns (cache pushes, chunk uploads,
    shell drains) can't interleave partial lines — a killed build
    leaves at worst one truncated FINAL line, and every line before it
    stays valid JSON.

    ``event_types`` optionally restricts the file to a set of event
    types — how the SLO smoke scenario writes an alert-only NDJSON
    artifact off the same bus the full event log rides."""

    def __init__(self, path: str,
                 event_types: "set[str] | None" = None) -> None:
        self.path = path
        self.event_types = (set(event_types)
                            if event_types is not None else None)
        self._f = open(path, "w", encoding="utf-8")
        self._lock = threading.Lock()
        self._closed = False

    def __call__(self, event: dict) -> None:
        if self.event_types is not None \
                and event.get("type") not in self.event_types:
            return
        line = json.dumps(event, separators=(",", ":"), default=str)
        with self._lock:
            if self._closed:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()


def read_jsonl(path: str, skip_invalid: bool = False) -> list[dict]:
    """Load an event log, skipping blank lines. A truncated final line
    (build killed mid-write) raises ``ValueError`` naming the line
    number; ``skip_invalid=True`` drops unparseable lines instead and
    keeps the valid ones — the salvage mode ``makisu-tpu report`` uses
    on logs of killed builds."""
    out: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, start=1):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError as e:
                if skip_invalid:
                    continue
                raise ValueError(
                    f"{path}:{i}: invalid event JSON: {e}") from e
    return out
