"""Storage census, reference audit, and integrity scrub.

Copy of ``makisu_tpu/cache/census.py``: the same document schema, plane
accounting, findings and renderers, so ``du`` and ``doctor --storage``
print the same text from either package over the same storage dir.
Four content planes grow on every worker: the blob CAS
(``<storage>/layers``), the chunk CAS (``<storage>/chunks``), pack
tables + seekable-zstd twins (``<storage>/serve/packs`` +
``serve/zpacks``), and sealed recipes (``<storage>/serve/recipes``).
The content store (``storage/contentstore.py``) evicts on what this
module measures: how many bytes each plane holds, which tenant put
them there, which objects are garbage, and whether bytes on disk still
hash to their names.

Three passes, all read-only (``doctor --storage --repair`` is the one
deliberate exception, and it touches only verified-orphaned zpack
twins):

* **Census** (:meth:`StorageCensus.census`): walk the planes under an
  :class:`IOBudget` (bytes/sec throttle + bounded resident buffer, the
  transfer engine's MemoryBudget idiom) and produce per-plane object
  counts, byte totals, age histograms, and per-tenant attribution
  joined from the cache-decision ledger's layer keys (objects
  predating attribution land in the ``unattributed`` bucket). Totals
  are cached atomically in ``<storage>/census.json`` so cheap
  consumers (history records) never pay for a walk.
* **Audit** (:meth:`StorageCensus.audit`): walk the recipe→pack→chunk
  and manifest→blob reference graphs and classify every object
  live / orphaned / dangling; torn index files are findings
  (``corrupt_index``), never crashes. The eviction dry-run
  (:meth:`StorageCensus.eviction_dry_run`) reports what the content
  store's policy at byte budget N *would* evict, and refuses to run
  against a live chunk CAS whose LRU seed has not finished (partial
  recency data evicts the wrong objects).
* **Scrub** (:meth:`StorageCensus.scrub`): sampled re-hash of N random
  chunks plus a zpack frame spot-check per cycle, rate-limited by the
  same budget. Corruption findings carry the object path and the
  expected/actual digest, ride the event bus as ``storage_finding``
  events, and bump the ``makisu_storage_scrub_*`` counters.

Like the rest of the telemetry layer: stdlib-only (hashlib, never a
kernel), never able to fail a build, and free when nothing asks.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import random
import threading
import time
from typing import Any, Iterator

from makisu_tpu_torch.utils import events, fileio
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

CENSUS_SCHEMA = "makisu-tpu.census.v1"
CENSUS_CACHE_FILE = "census.json"
ATTRIBUTION_FILE = "attribution.json"
ATTRIBUTION_SCHEMA = "makisu-tpu.attribution.v1"

# The four content planes, in the order every renderer shows them.
PLANES = ("blobs", "chunks", "packs", "recipes")

# Scrub/audit findings on the event bus (consumers that predate them
# skip unknown types by contract).
EVENT_TYPE = "storage_finding"

UNATTRIBUTED = "unattributed"

# Same cap discipline as the worker's per-tenant build counters: a
# hostile tenant mix must not explode the metrics registry.
TENANT_LABELS_KEEP = 32
TENANT_OVERFLOW = "other"

# Cap on per-kind itemized findings; the tail folds into one aggregate
# finding so a million orphans can't produce a million rows.
MAX_ITEMIZED = 100

# Attribution sidecar cap: newest entries win (the sidecar is a join
# hint, not a ledger — the ledger itself is the durable record).
ATTRIBUTION_KEEP = 8192

_HEX = set("0123456789abcdef")

_AGE_BUCKETS = ((3600, "1h"), (86400, "1d"),
                (7 * 86400, "1w"), (30 * 86400, "30d"))
AGE_LABELS = tuple(label for _, label in _AGE_BUCKETS) + ("older",)


def is_hex_digest(name: str) -> bool:
    return len(name) == 64 and all(c in _HEX for c in name)


def cap_label(tenant: str, index: int = 0,
              keep: int = TENANT_LABELS_KEEP) -> str:
    """Cardinality cap for tenant labels: the top ``keep`` tenants (by
    the caller's ordering) keep their names, the tail folds into
    ``other``. Empty attribution reads ``unattributed``."""
    tenant = str(tenant or "").strip()
    if not tenant:
        return UNATTRIBUTED
    if index >= keep:
        return TENANT_OVERFLOW
    return tenant[:64]


def _age_bucket(age_seconds: float) -> str:
    for limit, label in _AGE_BUCKETS:
        if age_seconds <= limit:
            return label
    return "older"


# -- IO budget --------------------------------------------------------------


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


class IOBudget:
    """Read-side budget for census/scrub walks: a bytes/sec throttle
    plus a bounded resident buffer, mirroring the transfer engine's
    MemoryBudget (``registry/transfer.py``): a counting semaphore over
    bytes with an oversized-request escape hatch — a single object
    larger than the whole budget is admitted alone rather than
    deadlocking. Deliberately BARGING for the same reason: scans are
    homogeneous, fairness machinery would be dead weight."""

    def __init__(self, bytes_per_second: int = 0,
                 max_resident_bytes: int = 64 << 20) -> None:
        self.bytes_per_second = max(0, int(bytes_per_second))
        self.max_resident = max(1, int(max_resident_bytes))
        self._cond = threading.Condition()
        self._resident = 0
        self._window_start = time.monotonic()
        self._window_bytes = 0

    @classmethod
    def from_env(cls) -> "IOBudget":
        return cls(
            bytes_per_second=_env_int(
                "MAKISU_TPU_CENSUS_BYTES_PER_SEC", 0),
            max_resident_bytes=_env_int(
                "MAKISU_TPU_CENSUS_MEMORY_BUDGET_MB", 64) << 20)

    @property
    def resident(self) -> int:
        with self._cond:
            return self._resident

    def acquire(self, nbytes: int) -> None:
        nbytes = max(0, int(nbytes))
        with self._cond:
            while True:
                if self._resident + nbytes <= self.max_resident:
                    break
                # Oversized object: admit alone once the buffer drains.
                if nbytes > self.max_resident and self._resident == 0:
                    break
                self._cond.wait()
            self._resident += nbytes

    def release(self, nbytes: int) -> None:
        with self._cond:
            self._resident = max(0, self._resident - max(0, int(nbytes)))
            self._cond.notify_all()

    @contextlib.contextmanager
    def reserve(self, nbytes: int) -> Iterator[None]:
        self.acquire(nbytes)
        try:
            yield
        finally:
            self.release(nbytes)

    def throttle(self, nbytes: int) -> None:
        """Account ``nbytes`` of reads against the bytes/sec limit,
        sleeping when the current 1-second window is over budget."""
        if self.bytes_per_second <= 0:
            return
        with self._cond:
            now = time.monotonic()
            elapsed = now - self._window_start
            if elapsed >= 1.0:
                self._window_start = now
                self._window_bytes = 0
                elapsed = 0.0
            self._window_bytes += max(0, int(nbytes))
            if self._window_bytes <= self.bytes_per_second:
                return
            delay = max(0.0, 1.0 - elapsed)
        if delay:
            time.sleep(delay)


# Streaming piece size for budgeted reads: bounded resident memory
# regardless of object size.
_READ_PIECE = 1 << 20


def _hash_file(path: str, budget: IOBudget) -> tuple[str, int]:
    """Stream-hash one file under the budget (resident buffer ≤ one
    piece; bytes/sec accounted per piece). Returns (hexdigest, size)."""
    digest = hashlib.sha256()
    total = 0
    with open(path, "rb") as fh:
        while True:
            with budget.reserve(_READ_PIECE):
                piece = fh.read(_READ_PIECE)
                if not piece:
                    break
                digest.update(piece)
            total += len(piece)
            budget.throttle(len(piece))
    return digest.hexdigest(), total


# -- findings ---------------------------------------------------------------


def make_finding(kind: str, severity: str, plane: str, detail: str,
                 **extra: Any) -> dict:
    finding = {"severity": severity, "kind": kind, "plane": plane,
               "detail": detail}
    finding.update({k: v for k, v in extra.items() if v is not None})
    return finding


def emit_finding(finding: dict) -> None:
    """Put one finding on the event bus (free no-op without sinks —
    same contract as ``events.emit``). Flight recorders and
    ``--events-out`` sinks pick it up without further wiring."""
    if events.active():
        events.emit(EVENT_TYPE, **finding)


# -- tenant attribution -----------------------------------------------------

_attr_lock = threading.Lock()


def _attribution_path(storage_dir: str) -> str:
    return os.path.join(storage_dir, ATTRIBUTION_FILE)


def load_attribution(storage_dir: str) -> dict[str, str]:
    """layer hex → tenant, best effort (a torn sidecar reads empty —
    objects fall back to the unattributed bucket, never a crash)."""
    try:
        with open(_attribution_path(storage_dir), encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    layers = doc.get("layers") if isinstance(doc, dict) else None
    if not isinstance(layers, dict):
        return {}
    out: dict[str, str] = {}
    for hx, row in layers.items():
        if not is_hex_digest(str(hx)):
            continue
        tenant = row.get("tenant") if isinstance(row, dict) else row
        if tenant:
            out[str(hx)] = str(tenant)
    return out


def record_attribution(storage_dir: str, tenant: str,
                       layer_hexes) -> None:
    """Merge ``layer hex → tenant`` rows into the storage dir's
    attribution sidecar (the census's join input, fed from the
    cache-decision ledger's layer keys by whoever knows the tenant —
    the worker's build path). Atomic write, capped at
    :data:`ATTRIBUTION_KEEP` newest entries, never raises."""
    hexes = [h for h in {str(h) for h in layer_hexes}
             if is_hex_digest(h)]
    if not tenant or not hexes:
        return
    path = _attribution_path(storage_dir)
    try:
        with _attr_lock:
            layers: dict[str, Any] = {}
            try:
                with open(path, encoding="utf-8") as f:
                    doc = json.load(f)
                if isinstance(doc, dict) \
                        and isinstance(doc.get("layers"), dict):
                    layers = dict(doc["layers"])
            except (OSError, ValueError):
                pass  # first write, or torn sidecar: start fresh
            now = time.time()
            for hx in hexes:
                layers[hx] = {"tenant": str(tenant), "ts": now}
            if len(layers) > ATTRIBUTION_KEEP:
                oldest = sorted(
                    layers.items(),
                    key=lambda kv: kv[1].get("ts", 0)
                    if isinstance(kv[1], dict) else 0)
                layers = dict(oldest[len(layers) - ATTRIBUTION_KEEP:])
            os.makedirs(storage_dir, exist_ok=True)
            fileio.write_json_atomic(
                path, {"schema": ATTRIBUTION_SCHEMA, "layers": layers})
    except OSError:
        log.info("attribution sidecar write failed for %s", storage_dir)


# -- cached totals (the cheap consumer path) --------------------------------


def cached_totals(storage_dir: str) -> dict | None:
    """Per-plane byte totals from the census cache file ONLY — never a
    walk. This is the history-record path: a build appending its
    record must not pay for a storage scan. Returns ``{plane: bytes}``
    (plus ``total``) or None when no census has run yet."""
    try:
        with open(os.path.join(storage_dir, CENSUS_CACHE_FILE),
                  encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    planes = doc.get("planes") if isinstance(doc, dict) else None
    if not isinstance(planes, dict):
        return None
    out: dict[str, int] = {}
    for plane in PLANES:
        row = planes.get(plane)
        if isinstance(row, dict):
            out[plane] = int(row.get("bytes", 0) or 0)
    if not out:
        return None
    out["total"] = int(doc.get("total_bytes", sum(out.values())) or 0)
    return out


# -- gauges -----------------------------------------------------------------


def publish_gauges(doc: dict) -> None:
    """Export one census document as ``makisu_storage_*`` gauges on
    the process registry (worker mode: the fleet front door's
    relabeled scrape carries them per-worker for free)."""
    for plane, row in (doc.get("planes") or {}).items():
        metrics.gauge_set(metrics.STORAGE_BYTES,
                          int(row.get("bytes", 0) or 0), plane=plane)
        metrics.gauge_set(metrics.STORAGE_OBJECTS,
                          int(row.get("objects", 0) or 0), plane=plane)
    for name, row in (doc.get("tenants") or {}).items():
        # Names were already folded through cap_label at census time;
        # the second pass is belt-and-braces (and what the
        # metric-registry rule verifies statically).
        metrics.gauge_set(metrics.STORAGE_TENANT_BYTES,
                          int(row.get("bytes", 0) or 0),
                          tenant=cap_label(name))
    metrics.counter_add(metrics.STORAGE_CENSUS_RUNS)


def publish_findings_gauge(findings: list[dict]) -> None:
    by_kind: dict[str, int] = {}
    for f in findings:
        by_kind[str(f.get("kind", "?"))] = \
            by_kind.get(str(f.get("kind", "?")), 0) + 1
    for kind, n in sorted(by_kind.items()):
        metrics.gauge_set(metrics.STORAGE_FINDINGS, n, kind=kind)


# -- the census -------------------------------------------------------------


class StorageCensus:
    """One storage root's census/audit/scrub engine. Cheap to
    construct; every pass re-walks the disk (the store mutates under
    us — builds publish, evictors delete — so holding an index would
    only mean holding a stale one)."""

    def __init__(self, storage_dir: str,
                 budget: IOBudget | None = None) -> None:
        self.storage_dir = os.path.abspath(storage_dir)
        self.budget = budget or IOBudget.from_env()
        self.layers_dir = os.path.join(self.storage_dir, "layers")
        self.chunks_dir = os.path.join(self.storage_dir, "chunks")
        self.manifests_dir = os.path.join(self.storage_dir, "manifests")
        serve = os.path.join(self.storage_dir, "serve")
        self.packs_dir = os.path.join(serve, "packs")
        self.zpacks_dir = os.path.join(serve, "zpacks")
        self.recipes_dir = os.path.join(serve, "recipes")
        # Session-snapshot recipes (worker/snapshots.py): accounted as
        # an occupant of the CHUNK plane — their shard bytes live in
        # the chunk CAS, the recipe JSON is just the plan over them.
        self.snapshots_dir = os.path.join(serve, "snapshots")

    # -- plane walks ------------------------------------------------------

    def _walk_cas(self, root: str) -> list[tuple[str, int, float]]:
        """CAS layout (``<root>/<aa>/<name>``): (name, size, mtime)
        per object, skipping the ``_tmp`` staging dir and in-flight
        ``*.tmp`` atomic-write staging files."""
        out: list[tuple[str, int, float]] = []
        try:
            shards = os.scandir(root)
        except OSError:
            return out
        with shards:
            for shard in shards:
                if shard.name == "_tmp" or not shard.is_dir():
                    continue
                try:
                    entries = os.scandir(shard.path)
                except OSError:
                    continue
                with entries:
                    for entry in entries:
                        if entry.name.endswith(".tmp"):
                            continue
                        try:
                            st = entry.stat()
                        except OSError:
                            continue  # deleted under us
                        if not entry.is_file():
                            continue
                        out.append((entry.name, st.st_size, st.st_mtime))
                        self.budget.throttle(256)  # stat accounting
        return out

    def _walk_flat(self, root: str,
                   suffix: str) -> list[tuple[str, int, float]]:
        out: list[tuple[str, int, float]] = []
        try:
            entries = os.scandir(root)
        except OSError:
            return out
        with entries:
            for entry in entries:
                if not entry.name.endswith(suffix) \
                        or entry.name.endswith(".tmp"):
                    continue
                try:
                    st = entry.stat()
                except OSError:
                    continue
                if not entry.is_file():
                    continue
                out.append((entry.name, st.st_size, st.st_mtime))
                self.budget.throttle(256)
        return out

    def _walk_manifests(self) -> list[tuple[str, int, float]]:
        out: list[tuple[str, int, float]] = []
        for dirpath, _, files in os.walk(self.manifests_dir):
            for fn in files:
                if not fn.endswith(".json") or fn.endswith(".tmp"):
                    continue
                p = os.path.join(dirpath, fn)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                rel = os.path.relpath(p, self.manifests_dir)
                out.append((rel, st.st_size, st.st_mtime))
                self.budget.throttle(256)
        return out

    # -- census -----------------------------------------------------------

    @staticmethod
    def _plane_stats(rows: list[tuple[str, int, float]],
                     now: float) -> dict:
        age: dict[str, int] = {label: 0 for label in AGE_LABELS}
        total = 0
        for _, size, mtime in rows:
            total += size
            age[_age_bucket(max(0.0, now - mtime))] += 1
        return {"objects": len(rows), "bytes": total, "age": age}

    def _load_recipes(self) -> tuple[dict[str, dict], list[dict]]:
        """Parse every recipe file; torn/malformed ones become
        ``corrupt_index`` findings instead of crashes (a mid-write
        truncation must never take the audit down)."""
        docs: dict[str, dict] = {}
        findings: list[dict] = []
        for name, size, _ in self._walk_flat(self.recipes_dir, ".json"):
            layer_hex = name[:-len(".json")]
            if not is_hex_digest(layer_hex):
                continue
            path = os.path.join(self.recipes_dir, name)
            try:
                with self.budget.reserve(size):
                    with open(path, encoding="utf-8") as f:
                        doc = json.load(f)
                self.budget.throttle(size)
                if not isinstance(doc, dict) \
                        or not isinstance(doc.get("chunks"), list):
                    raise ValueError("not a recipe document")
            except (OSError, ValueError, TypeError):
                findings.append(make_finding(
                    "corrupt_index", "error", "recipes",
                    f"recipe {layer_hex[:12]} is torn or malformed",
                    path=path, object=layer_hex))
                continue
            docs[layer_hex] = doc
        return docs, findings

    def _load_snapshot_recipes(self) -> tuple[dict[str, dict],
                                              list[dict]]:
        """Parse every session-snapshot recipe
        (``serve/snapshots/<snap_key>.json``); torn/malformed ones are
        ``corrupt_index`` findings, never crashes — same discipline as
        layer recipes. Returns ``{snap_key: doc}``."""
        docs: dict[str, dict] = {}
        findings: list[dict] = []
        for name, size, _ in self._walk_flat(self.snapshots_dir,
                                             ".json"):
            key = name[:-len(".json")]
            if not is_hex_digest(key):
                continue
            path = os.path.join(self.snapshots_dir, name)
            try:
                with self.budget.reserve(size):
                    with open(path, encoding="utf-8") as f:
                        doc = json.load(f)
                self.budget.throttle(size)
                if not isinstance(doc, dict) \
                        or not isinstance(doc.get("shards"), dict):
                    raise ValueError("not a snapshot recipe")
            except (OSError, ValueError, TypeError):
                findings.append(make_finding(
                    "corrupt_index", "error", "chunks",
                    f"session snapshot {key[:12]} is torn or "
                    f"malformed", path=path, object=key))
                continue
            docs[key] = doc
        return docs, findings

    def _load_pack_tables(self) -> tuple[
            dict[str, tuple[list, list | None]], list[dict]]:
        """Parse every pack table into ``{hex: (members, frames)}``;
        malformed tables are ``corrupt_index`` findings."""
        tables: dict[str, tuple[list, list | None]] = {}
        findings: list[dict] = []
        for name, size, _ in self._walk_flat(self.packs_dir, ".json"):
            pack_hex = name[:-len(".json")]
            if not is_hex_digest(pack_hex):
                continue
            path = os.path.join(self.packs_dir, name)
            try:
                with self.budget.reserve(size):
                    with open(path, encoding="utf-8") as f:
                        doc = json.load(f)
                self.budget.throttle(size)
                from makisu_tpu_torch.serve.recipe import RecipeStore
                members, frames = RecipeStore._parse_pack_table(doc)
            except (OSError, ValueError, TypeError, KeyError):
                findings.append(make_finding(
                    "corrupt_index", "error", "packs",
                    f"pack table {pack_hex[:12]} is torn or malformed",
                    path=path, object=pack_hex))
                continue
            tables[pack_hex] = (members, frames)
        return tables, findings

    def _manifest_refs(self) -> tuple[set[str], int]:
        """Blob hexes referenced by stored manifests (layer digests +
        config digests). Torn manifests are skipped (the manifest
        store overwrites them atomically; a torn one predates that)."""
        refs: set[str] = set()
        parsed = 0
        for rel, size, _ in self._walk_manifests():
            path = os.path.join(self.manifests_dir, rel)
            try:
                with self.budget.reserve(size):
                    with open(path, encoding="utf-8") as f:
                        doc = json.load(f)
                self.budget.throttle(size)
            except (OSError, ValueError):
                continue
            parsed += 1
            rows = list(doc.get("layers") or [])
            if isinstance(doc.get("config"), dict):
                rows.append(doc["config"])
            for row in rows:
                digest = str((row or {}).get("digest", "")) \
                    if isinstance(row, dict) else ""
                if digest.startswith("sha256:"):
                    digest = digest.split(":", 1)[1]
                if is_hex_digest(digest):
                    refs.add(digest)
        return refs, parsed

    def _attribute(self, recipes: dict[str, dict],
                   blobs: list, chunks: list,
                   zpack_rows: list, table_rows: list,
                   recipe_rows: list) -> dict[str, dict]:
        """Join objects to tenants through the attribution sidecar
        (layer hex → tenant, fed from the ledger's layer-keyed
        decisions). Chunks and packs inherit their recipe's tenant —
        first claimant wins for shared objects; everything unclaimed
        lands in the unattributed bucket."""
        attr = load_attribution(self.storage_dir)
        chunk_tenant: dict[str, str] = {}
        pack_tenant: dict[str, str] = {}
        recipe_tenant: dict[str, str] = {}
        for layer_hex, doc in recipes.items():
            tenant = attr.get(layer_hex, "")
            if not tenant:
                # Recipes are filed by gzip hex but the ledger may
                # have recorded the tar hex — accept either.
                tar = str((doc.get("layer") or {}).get("tar", ""))
                tenant = attr.get(tar, "")
            if not tenant:
                continue
            recipe_tenant[layer_hex] = tenant
            for row in doc.get("chunks") or []:
                try:
                    fp, _, pack_hex, _ = row
                except (TypeError, ValueError):
                    continue
                chunk_tenant.setdefault(str(fp), tenant)
                pack_tenant.setdefault(str(pack_hex), tenant)

        tenants: dict[str, dict] = {}

        def charge(tenant: str, nbytes: int) -> None:
            row = tenants.setdefault(tenant or UNATTRIBUTED,
                                     {"objects": 0, "bytes": 0})
            row["objects"] += 1
            row["bytes"] += nbytes

        for name, size, _ in blobs:
            charge(attr.get(name, ""), size)
        for name, size, _ in chunks:
            charge(chunk_tenant.get(name, ""), size)
        for name, size, _ in table_rows:
            charge(pack_tenant.get(name[:-len(".json")], ""), size)
        for name, size, _ in zpack_rows:
            charge(pack_tenant.get(name[:-len(".zst")], ""), size)
        for name, size, _ in recipe_rows:
            hx = name[:-len(".json")]
            charge(recipe_tenant.get(hx) or attr.get(hx, ""), size)

        # Fold the tail through the cardinality cap, biggest first.
        ordered = sorted(tenants.items(),
                         key=lambda kv: (-kv[1]["bytes"], kv[0]))
        capped: dict[str, dict] = {}
        for i, (tenant, row) in enumerate(ordered):
            label = (tenant if tenant == UNATTRIBUTED
                     else cap_label(tenant, i))
            agg = capped.setdefault(label, {"objects": 0, "bytes": 0})
            agg["objects"] += row["objects"]
            agg["bytes"] += row["bytes"]
        return capped

    def census(self, write_cache: bool = True,
               publish: bool = True) -> dict:
        """Walk all four planes; return the census document. Holds
        stat results only — never file contents — so resident memory
        is bounded by the object COUNT, not the byte total."""
        now = time.time()
        blobs = self._walk_cas(self.layers_dir)
        chunks = self._walk_cas(self.chunks_dir)
        table_rows = self._walk_flat(self.packs_dir, ".json")
        zpack_rows = self._walk_flat(self.zpacks_dir, ".zst")
        recipe_rows = self._walk_flat(self.recipes_dir, ".json")
        snapshot_rows = self._walk_flat(self.snapshots_dir, ".json")
        manifest_rows = self._walk_manifests()

        packs_stats = self._plane_stats(table_rows + zpack_rows, now)
        packs_stats["tables"] = len(table_rows)
        packs_stats["zpacks"] = len(zpack_rows)
        packs_stats["zpack_bytes"] = sum(s for _, s, _ in zpack_rows)
        # Session-snapshot recipes join the CHUNK plane's accounting
        # (their shard bytes already live in the chunk CAS; the recipe
        # JSON is the plan over them) with sub-counters so `du` and
        # /storage can attribute the occupancy.
        chunks_stats = self._plane_stats(chunks + snapshot_rows, now)
        chunks_stats["snapshots"] = len(snapshot_rows)
        chunks_stats["snapshot_bytes"] = sum(
            s for _, s, _ in snapshot_rows)
        planes = {
            "blobs": self._plane_stats(blobs, now),
            "chunks": chunks_stats,
            "packs": packs_stats,
            "recipes": self._plane_stats(recipe_rows, now),
        }
        recipes, _ = self._load_recipes()
        tenants = self._attribute(recipes, blobs, chunks,
                                  zpack_rows, table_rows, recipe_rows)
        total_objects = sum(p["objects"] for p in planes.values())
        total_bytes = sum(p["bytes"] for p in planes.values())
        doc = {
            "schema": CENSUS_SCHEMA,
            "generated_ts": now,
            "storage_dir": self.storage_dir,
            "planes": planes,
            "manifests": {"objects": len(manifest_rows),
                          "bytes": sum(s for _, s, _ in manifest_rows)},
            "total_objects": total_objects,
            "total_bytes": total_bytes,
            "tenants": tenants,
        }
        if publish:
            publish_gauges(doc)
        if write_cache:
            try:
                fileio.write_json_atomic(
                    os.path.join(self.storage_dir, CENSUS_CACHE_FILE),
                    doc)
            except OSError:
                log.info("census cache write failed for %s",
                         self.storage_dir)
        return doc

    # -- reference audit --------------------------------------------------

    def audit(self) -> dict:
        """Walk the recipe→pack→chunk and manifest→blob reference
        graphs. Returns ``{"classification": {plane: {live, orphaned,
        dangling, ...bytes}}, "findings": [...]}`` — every object
        classified, errors itemized (capped at
        :data:`MAX_ITEMIZED` per kind with an aggregate tail)."""
        findings: list[dict] = []
        recipes, recipe_findings = self._load_recipes()
        tables, table_findings = self._load_pack_tables()
        snapshots, snapshot_findings = self._load_snapshot_recipes()
        findings += recipe_findings + table_findings \
            + snapshot_findings

        chunk_rows = self._walk_cas(self.chunks_dir)
        chunk_names = {n for n, _, _ in chunk_rows}
        blob_rows = self._walk_cas(self.layers_dir)
        blob_names = {n for n, _, _ in blob_rows}
        zpack_rows = self._walk_flat(self.zpacks_dir, ".zst")

        # Demotion-aware reference check: a chunk absent from the CAS
        # whose pack survives as a compressed twin (or on the remote
        # tier) is DEMOTED, not dangling — the bytes are one local
        # decompress away and ensure_available promotes them back.
        # Only a missing chunk with no recoverable pack is an error.
        from makisu_tpu_torch.storage import contentstore
        _cstore = contentstore.store_for(self.storage_dir)
        _recoverable: dict[str, bool] = {}

        def pack_recoverable(pack_hex: str) -> bool:
            ok = _recoverable.get(pack_hex)
            if ok is None:
                ok = _recoverable[pack_hex] = \
                    _cstore.pack_recoverable(pack_hex)
            return ok

        demoted_chunks: set[str] = set()

        itemized: dict[str, int] = {}

        def add(kind: str, severity: str, plane: str, detail: str,
                **extra: Any) -> None:
            n = itemized.get(kind, 0)
            itemized[kind] = n + 1
            if n < MAX_ITEMIZED:
                findings.append(make_finding(
                    kind, severity, plane, detail, **extra))

        # recipe → chunk and recipe → pack rows. A recipe holds MANY
        # rows into the same pack, so a single missing/torn table
        # would otherwise repeat one identical finding per row —
        # dedupe on the (recipe, referent) edge, not the row.
        referenced_chunks: set[str] = set()
        referenced_packs: set[str] = set()
        dangling_recipes: set[str] = set()
        seen_edges: set[tuple[str, str, str]] = set()
        for layer_hex, doc in recipes.items():
            for row in doc.get("chunks") or []:
                try:
                    fp, _, pack_hex, _ = row
                except (TypeError, ValueError):
                    continue
                fp, pack_hex = str(fp), str(pack_hex)
                referenced_chunks.add(fp)
                referenced_packs.add(pack_hex)
                if (fp not in chunk_names
                        and ("chunk", layer_hex, fp)
                        not in seen_edges):
                    seen_edges.add(("chunk", layer_hex, fp))
                    if pack_recoverable(pack_hex):
                        demoted_chunks.add(fp)
                        continue
                    dangling_recipes.add(layer_hex)
                    add("dangling_chunk", "error", "recipes",
                        f"recipe {layer_hex[:12]} references chunk "
                        f"{fp[:12]} missing from the chunk CAS",
                        object=layer_hex, chunk=fp,
                        path=os.path.join(
                            self.recipes_dir, f"{layer_hex}.json"))
                if (pack_hex not in tables
                        and ("pack", layer_hex, pack_hex)
                        not in seen_edges):
                    seen_edges.add(("pack", layer_hex, pack_hex))
                    dangling_recipes.add(layer_hex)
                    add("dangling_pack", "error", "recipes",
                        f"recipe {layer_hex[:12]} references pack "
                        f"{pack_hex[:12]} with no table",
                        object=layer_hex, pack=pack_hex)

        # pack table → member chunks
        dangling_tables: set[str] = set()
        for pack_hex, (members, frames) in tables.items():
            for fp, _ in members:
                referenced_chunks.add(fp)
                if fp not in chunk_names:
                    if pack_recoverable(pack_hex):
                        demoted_chunks.add(fp)
                        continue
                    dangling_tables.add(pack_hex)
                    add("dangling_pack_member", "error", "packs",
                        f"pack {pack_hex[:12]} references evicted "
                        f"member chunk {fp[:12]}",
                        object=pack_hex, chunk=fp,
                        path=os.path.join(
                            self.packs_dir, f"{pack_hex}.json"))
            if frames:
                promised = int(frames[-1][2]) + int(frames[-1][3])
                zpath = os.path.join(self.zpacks_dir,
                                     f"{pack_hex}.zst")
                try:
                    actual = os.path.getsize(zpath)
                except OSError:
                    actual = -1  # absent twin: raw-only pack, fine
                if 0 <= actual < promised:
                    dangling_tables.add(pack_hex)
                    add("truncated_zpack", "error", "packs",
                        f"zpack {pack_hex[:12]} is {actual} bytes "
                        f"but its frame index promises {promised}",
                        object=pack_hex, path=zpath)

        # orphaned zpack twins: the crash window in
        # RecipeStore.publish writes the twin BEFORE the table that
        # indexes it (the safe ordering for readers), so a crash
        # between the two leaks the twin forever. Verified-orphaned
        # twins are what ``doctor --storage --repair`` deletes.
        orphaned_zpacks = 0
        orphaned_zpack_bytes = 0
        for name, size, _ in zpack_rows:
            pack_hex = name[:-len(".zst")]
            if not is_hex_digest(pack_hex) or pack_hex in tables:
                continue
            orphaned_zpacks += 1
            orphaned_zpack_bytes += size
            add("orphaned_zpack", "warning", "packs",
                f"zpack {pack_hex[:12]} has no pack table indexing "
                f"it (publish crash window); repairable",
                object=pack_hex, bytes=size, repairable=True,
                path=os.path.join(self.zpacks_dir, name))

        # session snapshot → shard chunks. A snapshot whose chunks
        # were evicted from under it is ORPHANED (restore will refuse
        # with chunks_unavailable; the recipe is reclaimable garbage),
        # classified and itemized — never a crash. Intact snapshots
        # keep their shard chunks LIVE, so chunk-plane eviction
        # accounting sees warm-state bytes as referenced occupants.
        orphaned_snapshots: set[str] = set()
        orphaned_snapshot_bytes = 0
        snapshot_sizes: dict[str, int] = {}
        for key, doc in snapshots.items():
            path = os.path.join(self.snapshots_dir, f"{key}.json")
            try:
                snapshot_sizes[key] = os.path.getsize(path)
            except OSError:
                snapshot_sizes[key] = 0
            for name, row in sorted(doc.get("shards", {}).items()):
                fp = str((row or {}).get("chunk", "")) \
                    if isinstance(row, dict) else ""
                if not is_hex_digest(fp):
                    continue
                referenced_chunks.add(fp)
                if fp not in chunk_names \
                        and key not in orphaned_snapshots:
                    orphaned_snapshots.add(key)
                    orphaned_snapshot_bytes += snapshot_sizes[key]
                    add("orphaned_snapshot", "warning", "chunks",
                        f"session snapshot {key[:12]} references "
                        f"evicted chunk {fp[:12]} (shard {name}); "
                        f"restore would refuse — recipe is "
                        f"reclaimable",
                        object=key, chunk=fp, path=path,
                        context=str(doc.get("context", "")))

        # manifest → blob
        manifest_refs, _ = self._manifest_refs()
        for hx in sorted(manifest_refs - blob_names):
            add("dangling_blob", "warning", "blobs",
                f"manifest references blob {hx[:12]} missing from "
                f"the layer CAS (lazy pull or eviction)", object=hx)
        recipe_blob_refs = set()
        for layer_hex, doc in recipes.items():
            gz = str((doc.get("layer") or {}).get("gzip", ""))
            if is_hex_digest(gz):
                recipe_blob_refs.add(gz)

        # aggregate tails past the itemization cap
        for kind, n in sorted(itemized.items()):
            if n > MAX_ITEMIZED:
                findings.append(make_finding(
                    kind, "info", "summary",
                    f"{n - MAX_ITEMIZED} more {kind} findings "
                    f"beyond the first {MAX_ITEMIZED}", count=n))

        # live / orphaned / dangling classification per plane
        chunk_sizes = {n: s for n, s, _ in chunk_rows}
        live_chunks = referenced_chunks & set(chunk_sizes)
        orphan_chunks = set(chunk_sizes) - referenced_chunks
        blob_refs = manifest_refs | recipe_blob_refs
        live_blobs = {n for n, _, _ in blob_rows if n in blob_refs}
        orphan_blobs = {n for n, _, _ in blob_rows
                        if n not in blob_refs}
        blob_sizes = {n: s for n, s, _ in blob_rows}
        orphan_tables = set(tables) - referenced_packs
        classification = {
            "chunks": {
                "live": len(live_chunks),
                "orphaned": len(orphan_chunks),
                "orphaned_bytes": sum(chunk_sizes[n]
                                      for n in orphan_chunks),
                "dangling": 0,
                # Referenced, absent from the CAS, recoverable from a
                # pack tier — the budget evictor's expected footprint.
                "demoted": len(demoted_chunks),
            },
            "blobs": {
                "live": len(live_blobs),
                "orphaned": len(orphan_blobs),
                "orphaned_bytes": sum(blob_sizes[n]
                                      for n in orphan_blobs),
                "dangling": 0,
            },
            "packs": {
                "live": len(tables) - len(orphan_tables)
                - len(dangling_tables - orphan_tables),
                "orphaned": len(orphan_tables) + orphaned_zpacks,
                "orphaned_bytes": orphaned_zpack_bytes,
                "dangling": len(dangling_tables),
            },
            "recipes": {
                "live": len(recipes) - len(dangling_recipes),
                "orphaned": 0,
                "orphaned_bytes": 0,
                "dangling": len(dangling_recipes),
            },
            "snapshots": {
                "live": len(snapshots) - len(orphaned_snapshots),
                "orphaned": len(orphaned_snapshots),
                "orphaned_bytes": orphaned_snapshot_bytes,
                "dangling": 0,
            },
        }
        severity_rank = {"error": 0, "warning": 1, "info": 2}
        findings.sort(key=lambda f: (
            severity_rank.get(f.get("severity"), 3),
            f.get("kind", ""), f.get("object", "")))
        publish_findings_gauge(findings)
        return {"classification": classification, "findings": findings}

    def repair_orphaned_zpacks(self, findings: list[dict],
                               apply: bool = False) -> dict:
        """Delete (or, dry-run, list) verified-orphaned zpack twins.
        Verification happens NOW, not at audit time: a table may have
        landed since, and deleting a newly-indexed twin would tear a
        pack a reader was promised."""
        removed: list[dict] = []
        skipped = 0
        for f in findings:
            if f.get("kind") != "orphaned_zpack" \
                    or not f.get("repairable"):
                continue
            pack_hex = str(f.get("object", ""))
            path = str(f.get("path", ""))
            if not is_hex_digest(pack_hex) or not path:
                skipped += 1
                continue
            if os.path.exists(os.path.join(
                    self.packs_dir, f"{pack_hex}.json")):
                skipped += 1  # table landed since the audit
                continue
            size = 0
            try:
                size = os.path.getsize(path)
                if apply:
                    os.unlink(path)
            except OSError:
                skipped += 1
                continue
            removed.append({"object": pack_hex, "path": path,
                            "bytes": size})
        return {"applied": bool(apply), "removed": removed,
                "skipped": skipped,
                "freed_bytes": sum(r["bytes"] for r in removed)}

    # -- eviction dry-run -------------------------------------------------

    def eviction_dry_run(self, budget_bytes: int,
                         seed_state: dict | None = None,
                         max_itemized: int = 50) -> dict:
        """What the eviction policy at byte budget N *would* evict
        from the CAS planes (chunks + blobs; packs and recipes follow
        their referents' lifecycle, they are not independent LRU
        victims). This is a DRY-RUN OF THE REAL EVICTOR, not a
        parallel estimate: rows, protected set, and victim order all
        come from storage/contentstore.py's one ``EvictionPolicy`` —
        the same objects a live ``ContentStore.evict`` would name.
        Refuses when a live chunk CAS reports its mtime seed is still
        running: a dry-run over partial recency data names the wrong
        victims."""
        if seed_state and seed_state.get("state") != "seeded":
            return {
                "refused": True,
                "reason": ("chunk CAS LRU seed is "
                           f"{seed_state.get('state')} — recency data "
                           "is partial; retry once seeded"),
                "seed": dict(seed_state),
                "budget_bytes": int(budget_bytes),
            }
        from makisu_tpu_torch.storage import contentstore
        rows = contentstore.collect_rows(self.storage_dir)
        policy = contentstore.policy_for(self.storage_dir)
        return policy.plan(rows, int(budget_bytes),
                           max_itemized=max_itemized)

    # -- integrity scrub --------------------------------------------------

    def scrub(self, chunk_samples: int = 8, pack_samples: int = 1,
              rng: random.Random | None = None) -> dict:
        """One scrub cycle: re-hash N random chunks against their
        fingerprint names, spot-check one zpack frame against bytes
        re-synthesized from its members (catching silent bit rot in
        the compressed twin), all under the IO budget. Corruption
        findings carry path + expected/actual digest and ride the
        event bus."""
        rng = rng or random.Random()
        findings: list[dict] = []
        chunks_checked = 0
        bytes_read = 0

        chunk_rows = self._walk_cas(self.chunks_dir)
        for name, _, _ in rng.sample(
                chunk_rows, min(chunk_samples, len(chunk_rows))):
            if not is_hex_digest(name):
                continue
            path = os.path.join(self.chunks_dir, name[:2], name)
            try:
                actual, n = _hash_file(path, self.budget)
            except OSError:
                continue  # evicted mid-scrub: not corruption
            chunks_checked += 1
            bytes_read += n
            if actual != name:
                findings.append(make_finding(
                    "corruption", "error", "chunks",
                    f"chunk {name[:12]} bytes do not hash to their "
                    f"name", path=path, object=name,
                    expected=name, actual=actual))

        packs_checked = 0
        tables, _ = self._load_pack_tables()
        zpack_checks = [
            (pack_hex, members, frames)
            for pack_hex, (members, frames) in sorted(tables.items())
            if frames and os.path.exists(
                os.path.join(self.zpacks_dir, f"{pack_hex}.zst"))]
        if zpack_checks and pack_samples > 0:
            from makisu_tpu_torch.utils import zstdio
            if zstdio.available():
                for pack_hex, members, frames in rng.sample(
                        zpack_checks,
                        min(pack_samples, len(zpack_checks))):
                    packs_checked += 1
                    finding, n = self._check_zpack_frame(
                        pack_hex, members, frames, rng)
                    bytes_read += n
                    if finding:
                        findings.append(finding)

        metrics.counter_add(metrics.STORAGE_SCRUB_CHUNKS,
                            chunks_checked)
        metrics.counter_add(metrics.STORAGE_SCRUB_BYTES, bytes_read)
        if findings:
            metrics.counter_add(metrics.STORAGE_SCRUB_CORRUPT,
                                len(findings))
        for finding in findings:
            emit_finding(finding)
        return {"chunks_checked": chunks_checked,
                "packs_checked": packs_checked,
                "bytes_read": bytes_read,
                "findings": findings}

    def _check_zpack_frame(self, pack_hex: str, members: list,
                           frames: list, rng: random.Random
                           ) -> tuple[dict | None, int]:
        """Decompress one random frame of the pack's zstd twin and
        compare against the raw range re-synthesized from member
        chunks. Members already flagged dangling are skipped — one
        finding per defect, not two."""
        from makisu_tpu_torch.utils import zstdio
        raw_off, raw_len, z_off, z_len = (
            int(v) for v in rng.choice(frames))
        zpath = os.path.join(self.zpacks_dir, f"{pack_hex}.zst")
        expected = bytearray()
        pos = 0
        bytes_read = 0
        try:
            for fp, length in members:
                start, end = pos, pos + int(length)
                pos = end
                if end <= raw_off or start >= raw_off + raw_len:
                    continue
                cpath = os.path.join(self.chunks_dir, fp[:2], fp)
                with self.budget.reserve(int(length)):
                    with open(cpath, "rb") as fh:
                        data = fh.read()
                self.budget.throttle(len(data))
                bytes_read += len(data)
                lo = max(raw_off, start) - start
                hi = min(raw_off + raw_len, end) - start
                expected += data[lo:hi]
            with self.budget.reserve(z_len):
                with open(zpath, "rb") as fh:
                    fh.seek(z_off)
                    zdata = fh.read(z_len)
            self.budget.throttle(len(zdata))
            bytes_read += len(zdata)
            actual = zstdio.decompress(zdata, raw_len)
        except (OSError, RuntimeError, ValueError):
            # Missing member/twin is the audit's dangling finding,
            # and a frame that won't decompress at all IS corruption.
            try:
                with open(zpath, "rb") as fh:
                    fh.seek(z_off)
                    zstdio.decompress(fh.read(z_len), raw_len)
                return None, bytes_read  # members missing, twin fine
            except (OSError, RuntimeError, ValueError):
                return make_finding(
                    "corruption", "error", "packs",
                    f"zpack {pack_hex[:12]} frame at z_off {z_off} "
                    f"fails to decompress", path=zpath,
                    object=pack_hex,
                    expected=hashlib.sha256(
                        bytes(expected)).hexdigest(),
                    actual="undecompressable"), bytes_read
        want = hashlib.sha256(bytes(expected)).hexdigest()
        got = hashlib.sha256(actual).hexdigest()
        if want != got:
            return make_finding(
                "corruption", "error", "packs",
                f"zpack {pack_hex[:12]} frame at raw offset "
                f"{raw_off} decompresses to wrong bytes",
                path=zpath, object=pack_hex,
                expected=want, actual=got), bytes_read
        return None, bytes_read

    # -- one-call report --------------------------------------------------

    def full_report(self, eviction_budget_bytes: int | None = None,
                    seed_state: dict | None = None,
                    scrub_samples: int = 8) -> dict:
        """Census + audit + scrub (+ optional eviction dry-run) in one
        document — what ``GET /storage`` and ``doctor --storage``
        serve. (Named ``full_report`` rather than ``report`` so the
        signal-safety analyzer never conflates it with the metric
        registry's ``report()`` on the crash-bundle path — a live
        store walk must never look signal-reachable.)"""
        doc = self.census()
        audit = self.audit()
        scrub = self.scrub(chunk_samples=scrub_samples)
        out = {
            "census": doc,
            "audit": audit,
            "scrub": scrub,
        }
        if eviction_budget_bytes is not None:
            out["eviction_dry_run"] = self.eviction_dry_run(
                eviction_budget_bytes, seed_state=seed_state)
        return out


# -- rendering --------------------------------------------------------------


def render_du(doc: dict) -> str:
    """Human table for ``makisu-tpu du``: one row per plane, the age
    histogram, and per-tenant attribution."""
    from makisu_tpu_torch.utils import traceexport
    lines = [f"storage census: {doc.get('storage_dir', '')}"]
    lines.append(f"  {'PLANE':<9} {'OBJECTS':>9} {'BYTES':>10}  AGE "
                 f"({'/'.join(AGE_LABELS)})")
    planes = doc.get("planes") or {}
    for plane in PLANES:
        row = planes.get(plane) or {}
        age = row.get("age") or {}
        ages = "/".join(str(age.get(label, 0))
                        for label in AGE_LABELS)
        lines.append(
            f"  {plane:<9} {row.get('objects', 0):>9} "
            f"{traceexport.fmt_bytes(row.get('bytes', 0)):>10}  "
            f"{ages}")
    lines.append(
        f"  {'total':<9} {doc.get('total_objects', 0):>9} "
        f"{traceexport.fmt_bytes(doc.get('total_bytes', 0)):>10}")
    chunk_row = planes.get("chunks") or {}
    if chunk_row.get("snapshots"):
        lines.append(
            f"  (chunks plane includes {chunk_row['snapshots']} "
            f"session-snapshot recipe(s), "
            f"{traceexport.fmt_bytes(chunk_row.get('snapshot_bytes', 0))})")
    tenants = doc.get("tenants") or {}
    if tenants:
        lines.append("  tenants:")
        for tenant, row in sorted(
                tenants.items(),
                key=lambda kv: (-kv[1].get("bytes", 0), kv[0])):
            lines.append(
                f"    {tenant:<24} "
                f"{traceexport.fmt_bytes(row.get('bytes', 0)):>10} "
                f"({row.get('objects', 0)} objects)")
    return "\n".join(lines) + "\n"


def render_storage_doctor(entries: list[dict], target: str) -> str:
    """Human diagnosis for ``doctor --storage``: per-dir census
    digest, classification, findings (severity-sorted), the eviction
    dry-run, and the zpack repair verdict."""
    from makisu_tpu_torch.utils import traceexport
    lines = [f"storage diagnosis: {target}"]
    total_findings = 0
    for entry in entries:
        doc = entry.get("census") or {}
        audit = entry.get("audit") or {}
        lines.append(f"\n== {entry.get('storage_dir', '?')}")
        planes = doc.get("planes") or {}
        summary = ", ".join(
            f"{plane} {traceexport.fmt_bytes((planes.get(plane) or {}).get('bytes', 0))}"
            f"/{(planes.get(plane) or {}).get('objects', 0)}"
            for plane in PLANES)
        lines.append(f"  census: {summary}")
        seed = entry.get("lru_seed")
        if seed:
            lines.append(
                f"  chunk CAS LRU seed: {seed.get('state', '?')} "
                f"({seed.get('seeded_entries', 0)} entries)")
        for plane, row in sorted(
                (audit.get("classification") or {}).items()):
            lines.append(
                f"  {plane}: live={row.get('live', 0)} "
                f"orphaned={row.get('orphaned', 0)} "
                f"dangling={row.get('dangling', 0)}")
        findings = list(audit.get("findings") or [])
        findings += list((entry.get("scrub") or {}).get(
            "findings") or [])
        total_findings += len(findings)
        if findings:
            lines.append("  findings:")
            for f in findings:
                where = f.get("object") or f.get("path") or ""
                extra = ""
                if f.get("expected") and f.get("actual"):
                    extra = (f" (expected {str(f['expected'])[:12]} "
                             f"actual {str(f['actual'])[:12]})")
                lines.append(
                    f"    [{f.get('severity', '?'):<7}] "
                    f"{f.get('kind', '?'):<20} {where}"
                    f"\n              {f.get('detail', '')}{extra}")
        else:
            lines.append("  findings: none")
        dry = entry.get("eviction_dry_run")
        if dry:
            if dry.get("refused"):
                lines.append(
                    f"  eviction dry-run: REFUSED — "
                    f"{dry.get('reason', '')}")
            else:
                actions = dry.get("actions") or {}
                tail = ""
                if actions.get("demote"):
                    tail += (f", {actions['demote']} demote to "
                             f"pack tier")
                if dry.get("pinned_skipped"):
                    tail += (f"; {dry['pinned_skipped']} pinned "
                             f"object(s) protected ("
                             f"{traceexport.fmt_bytes(dry.get('pinned_bytes', 0))})")
                lines.append(
                    f"  eviction dry-run @ "
                    f"{traceexport.fmt_bytes(dry.get('budget_bytes', 0))}: "
                    f"evict {dry.get('evict_count', 0)} objects, "
                    f"free "
                    f"{traceexport.fmt_bytes(dry.get('freed_bytes', 0))} "
                    f"(current "
                    f"{traceexport.fmt_bytes(dry.get('current_bytes', 0))})"
                    f"{tail}")
        cstore = entry.get("contentstore")
        if cstore:
            tiers = cstore.get("tiers") or {}
            budget = int(cstore.get("budget_bytes", 0) or 0)
            lines.append(
                f"  content store: budget "
                f"{traceexport.fmt_bytes(budget) if budget else 'unbounded'}"
                f", tiers hot="
                f"{traceexport.fmt_bytes(tiers.get('hot', 0))} "
                f"pack={traceexport.fmt_bytes(tiers.get('pack', 0))} "
                f"remote="
                f"{traceexport.fmt_bytes(tiers.get('remote', 0))}, "
                f"{cstore.get('pins', 0)} live pin(s), "
                f"{cstore.get('snapshot_pinned_chunks', 0)} "
                f"snapshot-pinned chunk(s)")
        repair = entry.get("repair")
        if repair:
            verb = ("deleted" if repair.get("applied")
                    else "would delete (dry-run; pass --repair)")
            lines.append(
                f"  zpack repair: {verb} "
                f"{len(repair.get('removed') or [])} orphaned "
                f"twin(s), "
                f"{traceexport.fmt_bytes(repair.get('freed_bytes', 0))}")
    lines.append(
        f"\n{total_findings} finding(s)" if total_findings
        else "\nno findings — storage planes are consistent")
    return "\n".join(lines) + "\n"


def seed_states(storage_dir: str) -> dict | None:
    """LRU seed state of the LIVE chunk CAS serving this storage dir,
    when one is registered in-process (worker mode); None offline —
    an offline walk's mtimes are complete by definition."""
    try:
        from makisu_tpu_torch.cache import chunks as chunks_mod
    except ImportError:  # pragma: no cover - partial install
        return None
    want = os.path.realpath(os.path.join(storage_dir, "chunks"))
    for store in chunks_mod.serving_stores():
        if os.path.realpath(store.cas.root) == want:
            state = getattr(store.cas, "seed_state", None)
            if callable(state):
                return state()
    return None
