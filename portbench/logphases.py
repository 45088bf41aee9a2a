"""A build's phases from its JSON log records, and what the host was doing
between two records.

The phase arithmetic is a frozen copy of ``chip_smoke.py:1228-1256``
(``run_build``), summed over every layer of the build where the smoke
took the first: parsing and the context's cache IDs before the first
stage; each layer's commit (its "committed layer" record's ``commit_s``);
each layer's KV write and index into the chunk CAS, from its "committed
layer" record to its "indexed" record; each cached layer's application,
from its "applying cached layer" record to its step's end.
"""

from __future__ import annotations

import json

# What the host does after a record with this prefix, until the next one.
AFTER = (
    ("build session ", "build: plan (context walk, stat cache)"),
    ("stat cache for ", "build: plan (context walk, stat cache)"),
    ("stage ", "build: step start"),
    ("cache hit ", "build: cache lookup (KV GET)"),
    ("step ", "build: step body (lookup, copy, sync wait, snapshot)"),
    ("created copy layer", "build: layer commit (diff, sink, session)"),
    ("committed layer ", "build: KV SET and chunk index"),
    ("pushing cache id", "build: KV SET and chunk index"),
    ("indexed ", "build: step end"),
    ("applying cached layer", "build: apply a cached layer"),
    ("computed total image size", "build: image manifest"),
    ("successfully built image", "build: exit"),
)


def read_log(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def is_step_end(r: dict) -> bool:
    return r["msg"].startswith("step ") and r["msg"].endswith(" done")


def phases(records: list[dict], start: float) -> dict:
    """``start``: the wall time just before the build was called."""
    out = {"plan_s": None, "commit_s": 0.0, "sync_s": 0.0, "diff_s": 0.0,
           "compress_s": 0.0, "session_s": 0.0, "index_s": 0.0,
           "apply_s": 0.0, "committed": 0, "hits": 0, "bytes_added": 0,
           "bytes_total": 0}
    last_commit = None
    for k, r in enumerate(records):
        msg = r["msg"]
        if msg.startswith("stage 1/") and out["plan_s"] is None:
            out["plan_s"] = r["ts"] - start
        elif msg.startswith("committed layer "):
            out["committed"] += 1
            for key in ("commit_s", "sync_s", "diff_s", "compress_s",
                        "session_s"):
                out[key] += r.get(key, 0.0)
            last_commit = r["ts"]
        elif msg.startswith("indexed ") and last_commit is not None:
            out["index_s"] += r["ts"] - last_commit
            out["bytes_added"] += r["bytes_added"]
            out["bytes_total"] += r["bytes_total"]
            last_commit = None
        elif msg.startswith("applying cached layer"):
            out["hits"] += 1
            end = next((q["ts"] for q in records[k:] if is_step_end(q)),
                       None)
            if end is not None:
                out["apply_s"] += end - r["ts"]
    return out


def label(msg: str) -> str:
    for prefix, what in AFTER:
        if msg.startswith(prefix):
            return what
    return "build: after '" + " ".join(msg.split()[:2]) + "'"


def intervals(records: list[dict], start: float, end: float) -> list:
    """(label, wall start, wall end) of the host's activity in one build,
    from the call's start through each record to the call's end."""
    out = []
    prev_ts, prev_label = start, "build: CLI start, plan"
    for r in sorted(records, key=lambda r: r["ts"]):
        out.append((prev_label, prev_ts, r["ts"]))
        prev_ts, prev_label = r["ts"], label(r["msg"])
    out.append((prev_label, prev_ts, end))
    return out
