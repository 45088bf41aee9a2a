"""Cache-decision ledger: every cache consult, attributed and durable.

Metrics count cache outcomes and events order them, but
neither can answer the question that gates the incremental-rebuild work:
*why* did this layer rebuild — which Dockerfile node broke the cache
chain, which files' changed bytes broke it, and how many bytes the
chunk plane actually had to re-move. This module is that record.

Every cache consult — the stat-cache probe behind a COPY/ADD cache ID,
the KV ``pull_cache`` entry lookup, the chunk-CAS existence scan, the
chunk-index dedup pass after a commit — records one structured
**decision** through the existing event bus as a ``cache_decision``
event:

```jsonc
{"ts": ..., "type": "cache_decision",
 "source": "kv" | "statcache" | "chunk_cas" | "chunk_index",
 "key": "<cache id / layer hex>",
 "verdict": "hit" | "miss" | "stale" | "error" | "empty" | "partial"
          | "indexed",
 "reason": "absent" | "kv_error" | "decode_error" | "layer_not_local"
         | "blob_gone" | "gz_backend" | "chunks_incomplete" | ...,
 // attribution (when a build node is in scope):
 "stage": "0", "step": 2, "directive": "COPY",
 // economics (source-specific):
 "bytes_saved": ..., "bytes_refetched": ..., "bytes_added": ...}
```

Because decisions ARE events, they reach every existing consumer for
free: ``--events-out``, the worker's live ``/build`` NDJSON frames, and
the flight recorder's ring. ``--explain-out FILE`` additionally writes
the compact per-build **ledger artifact**: a JSONL file holding a
header line (schema ``makisu-tpu.ledger.v1``), one line per decision,
and a trailing summary line with the aggregates (hit/miss counts by
source, bytes saved vs refetched, chunk dedup ratio, stat-cache blame).
``makisu-tpu explain`` renders miss attribution, build-to-build diffs,
and the warm-rebuild floor profile from these files
(``utils/explain.py``).

Like the rest of the telemetry layer: stdlib-only, context-scoped via
the event bus, free when no sink is bound, and never able to fail a
build.

Copy of ``makisu_tpu/utils/ledger.py``: the same schema and line
shapes, on this package's own event bus.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import threading
from typing import Any, Iterator

from makisu_tpu_torch.utils import events

LEDGER_SCHEMA = "makisu-tpu.ledger.v1"

# The ledger's event type on the bus (consumers that predate it skip
# unknown types by contract).
EVENT_TYPE = "cache_decision"

# Coarse miss-reason buckets for makisu_cache_miss_total{reason=...}.
# The ledger keeps the precise sub-reason; the counter keeps stable,
# low-cardinality series an alert can be written against.
COARSE_REASONS = {
    "absent": "absent",
    "kv_error": "kv_error",
    "decode_error": "decode_error",
    "layer_not_local": "stale",
    "blob_gone": "stale",
    "gz_backend": "stale",
    "chunks_incomplete": "stale",
}


def coarse_reason(reason: str | None) -> str:
    return COARSE_REASONS.get(reason or "", "absent")


# -- build-node attribution -------------------------------------------------

# Which Dockerfile node the current code is working FOR. Context-scoped
# like the metrics registry: threads a node's work spawns (async cache
# pushes, chunk uploads) inherit it via contextvars.copy_context, so a
# chunk-index decision landing seconds after the step finished still
# names the right node.
_node: "contextvars.ContextVar[dict | None]" = contextvars.ContextVar(
    "makisu_torch_ledger_node", default=None)


@contextlib.contextmanager
def node_scope(**fields: Any) -> Iterator[None]:
    """Attribute every decision recorded inside to this build node
    (``stage=<alias>, step=<index>, directive=<COPY|RUN|...>``)."""
    token = _node.set({k: v for k, v in fields.items() if v is not None})
    try:
        yield
    finally:
        _node.reset(token)


def current_node() -> dict | None:
    return _node.get()


def record(source: str, key: str, verdict: str,
           reason: str | None = None, **fields: Any) -> None:
    """Record one cache decision. Free no-op when no event sink is
    bound (same contract as ``events.emit``); never raises."""
    if not events.active():
        return
    payload: dict[str, Any] = {"source": source, "key": key,
                               "verdict": verdict}
    if reason:
        payload["reason"] = reason
    node = _node.get()
    if node:
        payload.update(node)
    payload.update(fields)
    events.emit(EVENT_TYPE, **payload)


# -- summary accumulation ---------------------------------------------------

# Cap on file paths carried in the summary's blame list: the ledger is
# a compact artifact; a 100k-file edit names the first N and counts the
# rest.
BLAME_FILES_KEEP = 50


class LedgerSummary:
    """Aggregates decisions into the trailing summary line. Shared by
    the writer (accumulating live) and the reader (recomputing when a
    torn ledger lost its summary line)."""

    def __init__(self) -> None:
        self.decisions = 0
        self.verdicts: dict[str, int] = {}
        self.by_source: dict[str, dict[str, int]] = {}
        self.bytes_saved = 0        # layer bytes served from cache
        self.bytes_refetched = 0    # chunk bytes moved over the wire
        self.bytes_added = 0        # novel chunk bytes (re-chunked)
        self.bytes_reused = 0       # chunk bytes dedup found locally
        self.chunks_indexed = 0
        self.chunks_reused = 0
        self.stat_hits = 0
        self.stat_misses = 0
        self.changed_files: list[str] = []
        self.exit_code: int | None = None

    def add(self, decision: dict) -> None:
        self.decisions += 1
        verdict = str(decision.get("verdict", "?"))
        source = str(decision.get("source", "?"))
        self.verdicts[verdict] = self.verdicts.get(verdict, 0) + 1
        per = self.by_source.setdefault(source, {})
        per[verdict] = per.get(verdict, 0) + 1
        self.bytes_saved += int(decision.get("bytes_saved", 0) or 0)
        self.bytes_refetched += int(
            decision.get("bytes_refetched", 0) or 0)
        if source == "chunk_index":
            self.bytes_added += int(decision.get("bytes_added", 0) or 0)
            self.bytes_reused += int(
                decision.get("bytes_reused", 0) or 0)
            self.chunks_indexed += int(decision.get("added", 0) or 0)
            self.chunks_reused += int(
                int(decision.get("chunks", 0) or 0)
                - int(decision.get("added", 0) or 0))
        if source == "statcache":
            self.stat_hits += int(decision.get("hits", 0) or 0)
            self.stat_misses += int(decision.get("misses", 0) or 0)
            for rel in decision.get("changed_files", []) or []:
                if (len(self.changed_files) < BLAME_FILES_KEEP
                        and rel not in self.changed_files):
                    self.changed_files.append(rel)

    def dedup_ratio(self) -> float:
        total = self.bytes_added + self.bytes_reused
        return self.bytes_reused / total if total else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "type": "summary",
            "decisions": self.decisions,
            "verdicts": dict(sorted(self.verdicts.items())),
            "by_source": {s: dict(sorted(v.items()))
                          for s, v in sorted(self.by_source.items())},
            "bytes_saved": self.bytes_saved,
            "bytes_refetched": self.bytes_refetched,
            "bytes_added": self.bytes_added,
            "bytes_reused": self.bytes_reused,
            "chunks_indexed": self.chunks_indexed,
            "chunks_reused": self.chunks_reused,
            "dedup_ratio": round(self.dedup_ratio(), 4),
            "statcache": {
                "hits": self.stat_hits,
                "misses": self.stat_misses,
                "changed_files": list(self.changed_files),
            },
            **({"exit_code": self.exit_code}
               if self.exit_code is not None else {}),
        }


class LedgerWriter:
    """Event sink writing the ``--explain-out`` ledger artifact.

    Filters the bus down to ``cache_decision`` events (one JSONL line
    each), bracketed by a header line (schema, trace id, command) on
    open and a summary line on :meth:`close`. Write discipline matches
    ``events.JsonlWriter``: line-at-a-time under a lock, flushed, so a
    killed build tears at most the final line."""

    def __init__(self, path: str, trace_id: str = "",
                 command: str = "") -> None:
        self.path = path
        self.summary = LedgerSummary()
        self._lock = threading.Lock()
        self._closed = False
        self._f = open(path, "w", encoding="utf-8")
        self._write({"schema": LEDGER_SCHEMA, "trace_id": trace_id,
                     "command": command})

    def _write(self, payload: dict) -> None:
        line = json.dumps(payload, separators=(",", ":"), default=str)
        self._f.write(line + "\n")
        self._f.flush()

    def __call__(self, event: dict) -> None:
        etype = event.get("type")
        with self._lock:
            if self._closed:
                return
            if etype == EVENT_TYPE:
                self.summary.add(event)
                self._write(event)
            elif etype == "build_end":
                # Captured for the summary only (cli.main emits it
                # before closing the writer); not a ledger line.
                self.summary.exit_code = event.get("exit_code")

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._write(self.summary.to_dict())
            finally:
                self._f.close()


def read_ledger(path: str, skip_invalid: bool = False) -> dict:
    """Load a ledger (or any ``--events-out`` log containing
    ``cache_decision`` events) into ``{"header": ..., "decisions":
    [...], "summary": ...}``. A ledger torn before its summary line
    (build killed mid-write) gets the summary recomputed from the
    decisions that survived — same salvage contract as
    ``events.read_jsonl(skip_invalid=True)``."""
    lines = events.read_jsonl(path, skip_invalid=skip_invalid)
    header: dict = {}
    summary: dict | None = None
    decisions: list[dict] = []
    for line in lines:
        if line.get("schema") == LEDGER_SCHEMA:
            header = line
        elif line.get("type") == "summary":
            summary = line
        elif line.get("type") == EVENT_TYPE:
            decisions.append(line)
        elif line.get("type") == "build_start" and not header:
            # An --events-out log doubles as ledger input: its
            # build_start line carries the same identity fields.
            header = {"schema": LEDGER_SCHEMA,
                      "trace_id": line.get("trace_id", ""),
                      "command": line.get("command", "")}
    if summary is None:
        acc = LedgerSummary()
        for decision in decisions:
            acc.add(decision)
        summary = acc.to_dict()
        summary["recomputed"] = True
    return {"header": header, "decisions": decisions,
            "summary": summary}
