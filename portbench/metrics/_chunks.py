"""The chunk lists of the layers that a window's builds committed, read
from the storage's file KV (``<storage>/cache_key_value.json``): each
build's "committed layer" records name the layers' gzip digests, and the
KV entry of each lists its chunks as (offset, length, digest)."""

import json
import os

import numpy as np

COMMITTED = "committed layer "


def _entries(storage: str, seen: dict) -> dict:
    """gzip digest -> KV entry of every layer in ``storage``'s file KV
    (read once per storage)."""
    if storage not in seen:
        path = os.path.join(storage, "cache_key_value.json")
        out = {}
        if os.path.exists(path):
            with open(path) as f:
                for value, _ts in json.load(f).values():
                    if value.startswith("{"):
                        entry = json.loads(value)
                        if "gzip" in entry and "chunks" in entry:
                            out[entry["gzip"]] = entry
        seen[storage] = out
    return seen[storage]


def committed_lengths(run):
    """The chunk lengths of every layer the window's builds committed, one
    array, or None where a build's layer has no KV entry to read."""
    seen: dict = {}
    lengths = []
    for rec in run.records:
        for r in rec.get("log") or ():
            if not r.get("msg", "").startswith(COMMITTED):
                continue
            storage = rec.get("storage")
            entry = _entries(storage, seen).get(r["msg"].split()[2]) \
                if storage else None
            if entry is None:
                return None
            lengths.append(np.fromiter((c[1] for c in entry["chunks"]),
                                       dtype=np.int64))
    return np.concatenate(lengths) if lengths else None
