"""One content store over the four planes: refcounts, budget eviction,
tenant quotas, hot/cold tiering.

Copy of ``makisu_tpu/storage/contentstore.py`` with the same on-disk
layout, knobs and decisions, so one storage dir is governed alike by
either package. The census (``cache/census.py``) measures the four
content planes (blob CAS, chunk CAS, packs/zpacks, recipes and
snapshots); this module turns a worker's disk into a cache: bounded by
a byte budget, evictable under one policy that the ``doctor --storage``
dry run shares, and refillable from the pack tiers.

Three layers, all keyed by the storage directory:

- **PinBoard**: the live refcount plane. Counted pins per
  ``(plane, name)`` from in-flight reads (``ChunkStore.get``,
  ``open_stream``, peer pack-range serving) plus structural pins from
  on-disk reference graphs (session-snapshot recipes pin their shard
  chunks). A pinned object is never an eviction victim, and the chunk
  CAS's own count-LRU skips it too (``CASStore.pin_check``).

- **EvictionPolicy**: the eviction decision, one implementation.
  ``doctor --storage --eviction-budget N`` and the live evictor feed it
  the same rows (``collect_rows``) and the same protected set. LRU by
  recency (file mtime, overlaid with the live store's in-memory access
  times when one is registered); objects owned by a tenant over its
  soft quota evict first.

- **ContentStore**: executes the plan and runs the tier lifecycle:
  *hot* (raw chunk and blob bytes), then *pack* (a chunk whose pack has
  a seekable-zstd twin demotes to pack membership: the raw file is
  deleted, the bytes stay recoverable from the compressed frames), then
  *remote* (cold zpacks, or raw packs materialized when libzstd was
  absent at publish time, move to an object-tier directory,
  ``--storage-remote``). Refetch promotes on demand through the frame
  and run planners the ranged-pack wire uses, charges the transfer
  engine's memory budget per range, and checks every carved chunk
  against its digest before the CAS takes it back.

Knobs (flag first, env fallback):

- ``--storage-budget`` / ``MAKISU_TPU_STORAGE_BUDGET_MB``: per-worker
  hot-tier byte budget (chunks + blobs). 0/unset = unbounded.
- ``--storage-remote`` / ``MAKISU_TPU_STORAGE_REMOTE``: object-tier
  directory for demoted packs. Unset = packs stay local.
- ``MAKISU_TPU_STORAGE_TENANT_QUOTA_MB``: per-tenant soft quota;
  over-quota tenants' cold objects evict first (never blocks a build).
- ``MAKISU_TPU_STORAGE_EVICT_SECONDS``: min seconds between
  ``maybe_evict`` passes (default 5; 0 = every call).

Host policy only: nothing here touches the card, and ``maybe_evict``
never fails a finished build.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from contextlib import contextmanager

from makisu_tpu_torch.utils import events, fileio
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics

TIERS = ("hot", "pack", "remote")

# Eviction reasons (the `reason` label on
# makisu_storage_evictions_total): `demote` — chunk deleted but
# recoverable from its pack's compressed twin or the remote tier;
# `demote_pack` — a cold zpack moved to the remote tier; `quota` — a
# victim chosen early because its tenant is over soft quota; `lru` —
# plain cold eviction with no tier backing (refetch degrades to the
# peer/registry routes).
EVICT_REASONS = ("demote", "demote_pack", "quota", "lru")


# -- configuration -----------------------------------------------------------

_config_mu = threading.Lock()
_config: dict = {"budget_bytes": None, "remote_dir": None,
                 "tenant_quota_bytes": None}
_dir_budgets: dict[str, int] = {}  # per-storage-dir override (tests/soak)


def configure(budget_mb: int | None = None, remote: str | None = None,
              tenant_quota_mb: int | None = None) -> None:
    """Process-wide defaults from CLI flags (`--storage-budget`,
    `--storage-remote`); the env vars below stay the fallback read at
    use time. None leaves a setting untouched."""
    with _config_mu:
        if budget_mb is not None:
            _config["budget_bytes"] = max(0, int(budget_mb)) << 20
        if remote is not None:
            _config["remote_dir"] = remote or None
        if tenant_quota_mb is not None:
            _config["tenant_quota_bytes"] = \
                max(0, int(tenant_quota_mb)) << 20


def set_budget_for(storage_dir: str, budget_bytes: int | None) -> None:
    """Per-directory budget override (the eviction soak runs a
    budgeted worker and an unbudgeted oracle in one process)."""
    key = os.path.realpath(storage_dir)
    with _config_mu:
        if budget_bytes is None:
            _dir_budgets.pop(key, None)
        else:
            _dir_budgets[key] = int(budget_bytes)
        _stores.pop(key, None)  # rebuilt with the new budget


def _env_mb(name: str) -> int | None:
    raw = os.environ.get(name, "")
    if not raw:
        return None
    try:
        return max(0, int(raw)) << 20
    except ValueError:
        return None


def budget_bytes_for(storage_dir: str) -> int:
    """Resolved hot-tier budget for this dir; 0 = unbounded."""
    key = os.path.realpath(storage_dir)
    with _config_mu:
        if key in _dir_budgets:
            return _dir_budgets[key]
        if _config["budget_bytes"] is not None:
            return _config["budget_bytes"]
    return _env_mb("MAKISU_TPU_STORAGE_BUDGET_MB") or 0


def remote_tier_dir() -> str | None:
    with _config_mu:
        if _config["remote_dir"] is not None:
            return _config["remote_dir"]
    return os.environ.get("MAKISU_TPU_STORAGE_REMOTE") or None


def tenant_quota_bytes() -> int:
    with _config_mu:
        if _config["tenant_quota_bytes"] is not None:
            return _config["tenant_quota_bytes"]
    return _env_mb("MAKISU_TPU_STORAGE_TENANT_QUOTA_MB") or 0


def evict_interval_seconds() -> float:
    raw = os.environ.get("MAKISU_TPU_STORAGE_EVICT_SECONDS", "")
    try:
        return max(0.0, float(raw)) if raw else 5.0
    except ValueError:
        return 5.0


# -- the refcount plane ------------------------------------------------------

class PinBoard:
    """Counted live pins per ``(plane, name)`` for one storage root.

    A pin is a promise an eviction pass must honor: the object is
    under an in-flight read (build indexing, peer pack-range serving,
    a streamed layer apply) or held by a resident surface. Pins are
    process-local by design — cross-process readers are covered by
    POSIX unlink semantics (an open fd survives the unlink); the pin
    closes the stat→open window and keeps *logical* integrity (an
    in-flight ``open_stream`` must not see its next chunk vanish)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._pins: dict[tuple[str, str], int] = {}

    def pin(self, plane: str, name: str) -> None:
        key = (plane, name)
        with self._mu:
            self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, plane: str, name: str) -> None:
        key = (plane, name)
        with self._mu:
            n = self._pins.get(key, 0) - 1
            if n <= 0:
                self._pins.pop(key, None)
            else:
                self._pins[key] = n

    @contextmanager
    def pinned(self, plane: str, name: str):
        self.pin(plane, name)
        try:
            yield
        finally:
            self.unpin(plane, name)

    def is_pinned(self, plane: str, name: str) -> bool:
        with self._mu:
            return (plane, name) in self._pins

    def chunk_pinned(self, name: str) -> bool:
        """``CASStore.pin_check`` shape: name-only, chunks plane."""
        return self.is_pinned("chunks", name)

    def snapshot(self) -> dict[tuple[str, str], int]:
        with self._mu:
            return dict(self._pins)

    def count(self) -> int:
        with self._mu:
            return len(self._pins)


_boards_mu = threading.Lock()
_boards: dict[str, PinBoard] = {}


def board_for(storage_dir: str) -> PinBoard:
    key = os.path.realpath(storage_dir)
    with _boards_mu:
        board = _boards.get(key)
        if board is None:
            board = _boards[key] = PinBoard()
        return board


def storage_dir_for_chunk_root(chunk_root: str) -> str:
    """A chunk CAS at ``<storage>/chunks`` keys pins/tiers by its
    parent storage dir (the same disambiguation the worker's
    ``add_served_chunk_root`` applies); a bare nonstandard CAS path
    keys by itself."""
    root = os.path.realpath(chunk_root)
    if os.path.basename(root) == "chunks":
        return os.path.dirname(root)
    return root


def board_for_chunk_root(chunk_root: str) -> PinBoard:
    return board_for(storage_dir_for_chunk_root(chunk_root))


def snapshot_pinned_chunks(storage_dir: str) -> set[str]:
    """Shard-chunk fingerprints held by session-snapshot recipes
    (``serve/snapshots/*.json``) — the structural refcount source. A
    snapshot exists to survive a kill -9; eviction breaking its warm
    restore would defeat it, so its shards are protected while the
    recipe is. (Recipes themselves stay subject to their own
    lifecycle; deleting the recipe releases the pins.)"""
    out: set[str] = set()
    snap_dir = os.path.join(storage_dir, "serve", "snapshots")
    try:
        names = os.listdir(snap_dir)
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(snap_dir, name),
                      encoding="utf-8") as f:
                doc = json.load(f)
            shards = doc.get("shards")
            if not isinstance(shards, dict):
                continue
            for row in shards.values():
                fp = str((row or {}).get("chunk", ""))
                if fp:
                    out.add(fp)
        except (OSError, ValueError, TypeError, AttributeError):
            continue  # torn recipe: the audit classifies it, not us
    return out


def protected_set(storage_dir: str) -> tuple[set[tuple[str, str]], dict]:
    """Everything an eviction pass must not name as a victim: live
    pins plus snapshot-recipe shard chunks. Returns (set, counts)."""
    board = board_for(storage_dir)
    live = set(board.snapshot())
    snaps = {("chunks", fp)
             for fp in snapshot_pinned_chunks(storage_dir)}
    counts = {"live_pins": len(live), "snapshot_chunks": len(snaps)}
    return live | snaps, counts


# -- decision input ----------------------------------------------------------

def _live_chunk_store(storage_dir: str):
    """The registered in-process ChunkStore serving this storage's
    CAS, or None (offline walk)."""
    from makisu_tpu_torch.cache import chunks as chunks_mod
    want = os.path.realpath(os.path.join(storage_dir, "chunks"))
    for store in chunks_mod.serving_stores():
        if os.path.realpath(store.cas.root) == want:
            return store
    return None


def collect_rows(storage_dir: str
                 ) -> list[tuple[float, int, str, str]]:
    """The eviction decision input: ``(recency, size, plane, name)``
    per hot-tier object (chunks + blobs; packs and recipes follow
    their referents' lifecycle). Recency is file mtime — overlaid
    with the live chunk store's in-memory access times when one is
    registered, so the dry-run and the evictor judge reads the LRU
    actually saw, not just writes."""
    from makisu_tpu_torch.cache import census as census_mod
    engine = census_mod.StorageCensus(storage_dir)
    live = _live_chunk_store(storage_dir)
    recency: dict[str, float] = {}
    if live is not None:
        recency = live.cas.recency()
    rows: list[tuple[float, int, str, str]] = []
    for name, size, mtime in engine._walk_cas(engine.chunks_dir):
        rows.append((recency.get(name, mtime), size, "chunks", name))
    for name, size, mtime in engine._walk_cas(engine.layers_dir):
        rows.append((mtime, size, "blobs", name))
    return rows


def tenant_map(storage_dir: str) -> dict[tuple[str, str], str]:
    """Object → tenant join for the quota tie-break: blobs straight
    from the attribution sidecar, chunks inheriting their recipe's
    tenant (first claimant wins — the census's attribution rule)."""
    from makisu_tpu_torch.cache import census as census_mod
    attr = census_mod.load_attribution(storage_dir)
    out: dict[tuple[str, str], str] = {}
    if not attr:
        return out
    for name, tenant in attr.items():
        out[("blobs", name)] = tenant
    recipes_dir = os.path.join(storage_dir, "serve", "recipes")
    try:
        names = os.listdir(recipes_dir)
    except OSError:
        return out
    for fname in names:
        if not fname.endswith(".json"):
            continue
        layer_hex = fname[:-len(".json")]
        tenant = attr.get(layer_hex, "")
        try:
            with open(os.path.join(recipes_dir, fname),
                      encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict):
            continue
        if not tenant:
            tenant = attr.get(
                str((doc.get("layer") or {}).get("tar", "")), "")
        if not tenant:
            continue
        for row in doc.get("chunks") or []:
            try:
                fp = str(row[0])
            except (TypeError, IndexError):
                continue
            out.setdefault(("chunks", fp), tenant)
    return out


# -- the eviction policy -----------------------------------------------------

class EvictionPolicy:
    """THE eviction decision — one implementation consumed by both
    the ``doctor --storage --eviction-budget N`` dry-run and the live
    evictor, so predictions and reality cannot drift.

    Victim order: objects owned by an over-soft-quota tenant first
    (oldest first within them), then global LRU by recency. Protected
    objects (live pins + snapshot shard chunks) are never victims;
    their bytes are reported so an over-pinned store is visible
    instead of silently un-evictable."""

    def __init__(self, protected: set | frozenset = frozenset(),
                 tenant_of: dict | None = None,
                 over_quota: set | frozenset = frozenset(),
                 demotable: set | frozenset = frozenset()) -> None:
        self.protected = protected
        self.tenant_of = tenant_of or {}
        self.over_quota = over_quota
        self.demotable = demotable

    def _key(self, row: tuple[float, int, str, str]):
        recency, _, plane, name = row
        tenant = self.tenant_of.get((plane, name), "")
        return (0 if tenant and tenant in self.over_quota else 1,
                recency, name)

    def plan(self, rows: list[tuple[float, int, str, str]],
             budget_bytes: int, max_itemized: int = 50,
             include_candidates: bool = False) -> dict:
        """The dry-run document (the census's dry-run schema) —
        also exactly what the evictor executes. ``candidates`` (full
        victim list, opt-in: it can be huge) carries per-victim
        ``(plane, name, bytes, action, reason)``."""
        current = sum(size for _, size, _, _ in rows)
        pinned_skipped = 0
        pinned_bytes = 0
        pool: list[tuple[float, int, str, str]] = []
        for row in rows:
            if (row[2], row[3]) in self.protected:
                pinned_skipped += 1
                pinned_bytes += row[1]
            else:
                pool.append(row)
        pool.sort(key=self._key)
        freed = 0
        evict_count = 0
        victims: list[dict] = []
        candidates: list[tuple[str, str, int, str, str]] = []
        actions = {"demote": 0, "evict": 0}
        now = time.time()
        for row in pool:
            if current - freed <= budget_bytes:
                break
            recency, size, plane, name = row
            freed += size
            evict_count += 1
            tenant = self.tenant_of.get((plane, name), "")
            action = ("demote"
                      if plane == "chunks" and name in self.demotable
                      else "evict")
            actions[action] += 1
            reason = ("quota" if tenant and tenant in self.over_quota
                      else "demote" if action == "demote" else "lru")
            if len(victims) < max_itemized:
                item = {"plane": plane, "object": name, "bytes": size,
                        "age_seconds": round(max(0.0, now - recency),
                                             1),
                        "action": action}
                if tenant:
                    item["tenant"] = tenant
                victims.append(item)
            if include_candidates:
                candidates.append((plane, name, size, action, reason))
        doc = {
            "refused": False,
            "budget_bytes": int(budget_bytes),
            "current_bytes": current,
            "evict_count": evict_count,
            "freed_bytes": freed,
            "remaining_bytes": current - freed,
            "would_evict": victims,
            "actions": actions,
            "pinned_skipped": pinned_skipped,
            "pinned_bytes": pinned_bytes,
        }
        if include_candidates:
            doc["candidates"] = candidates
        return doc


def policy_for(storage_dir: str) -> EvictionPolicy:
    """The policy both the census dry-run and ``ContentStore.evict``
    construct: same protected set, same tenant join, same demotable
    set — parity by construction."""
    protected, _ = protected_set(storage_dir)
    tenants = tenant_map(storage_dir)
    quota = tenant_quota_bytes()
    over: set[str] = set()
    if quota > 0 and tenants:
        usage: dict[str, int] = {}
        for recency, size, plane, name in collect_rows(storage_dir):
            tenant = tenants.get((plane, name), "")
            if tenant:
                usage[tenant] = usage.get(tenant, 0) + size
        over = {t for t, b in usage.items() if b > quota}
    store = store_for(storage_dir)
    return EvictionPolicy(protected=protected, tenant_of=tenants,
                          over_quota=over,
                          demotable=store.demotable_chunks())


# -- counters (process-wide, also exported as metrics) -----------------------

_counter_mu = threading.Lock()
_counters = {"evictions": 0, "evicted_bytes": 0, "refetch_bytes": 0,
             "refetched_chunks": 0}


def _count(key: str, n: int = 1) -> None:
    with _counter_mu:
        _counters[key] = _counters.get(key, 0) + n


def counters() -> dict:
    with _counter_mu:
        return dict(_counters)


# -- the unified store -------------------------------------------------------

class ContentStore:
    """One storage root's unified content surface: refcounts, the
    budget evictor, tier accounting, demotion and refetch."""

    def __init__(self, storage_dir: str,
                 budget_bytes: int | None = None,
                 remote_dir: str | None = None) -> None:
        self.storage_dir = os.path.realpath(storage_dir)
        self._budget = budget_bytes
        self._remote = remote_dir
        self.board = board_for(self.storage_dir)
        self.chunks_dir = os.path.join(self.storage_dir, "chunks")
        self.layers_dir = os.path.join(self.storage_dir, "layers")
        serve = os.path.join(self.storage_dir, "serve")
        self.packs_dir = os.path.join(serve, "packs")
        self.zpacks_dir = os.path.join(serve, "zpacks")
        self._recipes = None
        self._mu = threading.Lock()
        self._last_evict_mono = 0.0
        self._last_eviction: dict = {}
        self._pack_index: dict[str, tuple[str, int, int]] = {}
        self._pack_index_sig: tuple | None = None

    # -- knobs resolved at use time (flags/env may land after init) --

    @property
    def budget_bytes(self) -> int:
        if self._budget is not None:
            return self._budget
        return budget_bytes_for(self.storage_dir)

    @property
    def remote_dir(self) -> str | None:
        return self._remote if self._remote is not None \
            else remote_tier_dir()

    def _recipe_store(self):
        if self._recipes is None:
            from makisu_tpu_torch.serve.recipe import RecipeStore
            self._recipes = RecipeStore(
                os.path.join(self.storage_dir, "serve"),
                self.chunks_dir)
        return self._recipes

    # -- accounting --------------------------------------------------

    def hot_bytes(self) -> int:
        return sum(size for _, size, _, _ in
                   collect_rows(self.storage_dir))

    def _dir_bytes(self, root: str, suffix: str = "") -> int:
        total = 0
        try:
            with os.scandir(root) as entries:
                for e in entries:
                    if suffix and not e.name.endswith(suffix):
                        continue
                    try:
                        if e.is_file():
                            total += e.stat().st_size
                    except OSError:
                        continue
        except OSError:
            return 0
        return total

    def tier_bytes(self, publish: bool = True) -> dict:
        """Per-tier byte totals: hot (raw chunks + blobs), pack
        (local compressed twins), remote (the object-tier dir)."""
        remote = 0
        rdir = self.remote_dir
        if rdir:
            remote = (self._dir_bytes(os.path.join(rdir, "zpacks"))
                      + self._dir_bytes(os.path.join(rdir, "packs")))
        tiers = {
            "hot": self.hot_bytes(),
            "pack": self._dir_bytes(self.zpacks_dir, ".zst"),
            "remote": remote,
        }
        if publish:
            for tier, nbytes in tiers.items():
                metrics.gauge_set(metrics.STORAGE_TIER_BYTES, nbytes,
                                  tier=tier)
        return tiers

    # -- pack coordinates (the chunk → pack join) --------------------

    def pack_index(self) -> dict[str, tuple[str, int, int]]:
        """fp → (pack_hex, offset_in_pack, length), parsed from the
        on-disk pack tables; cached until the packs dir changes."""
        try:
            names = sorted(n for n in os.listdir(self.packs_dir)
                           if n.endswith(".json"))
        except OSError:
            names = []
        sig = (len(names), names[-1] if names else "")
        with self._mu:
            if sig == self._pack_index_sig:
                return self._pack_index
        rs = self._recipe_store()
        index: dict[str, tuple[str, int, int]] = {}
        for fname in names:
            pack_hex = fname[:-len(".json")]
            members = rs.pack_members(pack_hex)
            if not members:
                continue
            off = 0
            for fp, length in members:
                index.setdefault(str(fp),
                                 (pack_hex, off, int(length)))
                off += int(length)
        with self._mu:
            self._pack_index = index
            self._pack_index_sig = sig
        return index

    def _local_zpack(self, pack_hex: str) -> str | None:
        p = os.path.join(self.zpacks_dir, f"{pack_hex}.zst")
        return p if os.path.isfile(p) else None

    def _remote_paths(self, pack_hex: str) -> tuple[str | None,
                                                    str | None]:
        rdir = self.remote_dir
        if not rdir:
            return None, None
        z = os.path.join(rdir, "zpacks", f"{pack_hex}.zst")
        raw = os.path.join(rdir, "packs", f"{pack_hex}.pack")
        return (z if os.path.isfile(z) else None,
                raw if os.path.isfile(raw) else None)

    def pack_recoverable(self, pack_hex: str) -> bool:
        """True when the pack's bytes survive chunk eviction: a
        compressed twin locally, or either shape on the remote tier."""
        if self._local_zpack(pack_hex):
            return True
        z, raw = self._remote_paths(pack_hex)
        return bool(z or raw)

    def demotable_chunks(self) -> set[str]:
        """Chunk fps whose raw CAS file may be deleted without losing
        the bytes: their pack is recoverable now, or could be made so
        by demoting it to a configured remote tier first."""
        index = self.pack_index()
        can_demote_packs = bool(self.remote_dir)
        out: set[str] = set()
        recoverable: dict[str, bool] = {}
        for fp, (pack_hex, _, _) in index.items():
            ok = recoverable.get(pack_hex)
            if ok is None:
                ok = self.pack_recoverable(pack_hex) \
                    or can_demote_packs
                recoverable[pack_hex] = ok
            if ok:
                out.add(fp)
        return out

    # -- demotion ----------------------------------------------------

    def demote_pack(self, pack_hex: str) -> bool:
        """Move this pack's recoverable form onto the remote tier:
        the local zpack when one exists, else a raw pack materialized
        from member chunks (libzstd-less publishers) — verified
        against the pack hex while written. True when the pack is
        recoverable from the remote tier afterwards."""
        rdir = self.remote_dir
        if not rdir:
            return False
        z, raw = self._remote_paths(pack_hex)
        if z or raw:
            return True
        local_z = self._local_zpack(pack_hex)
        if local_z:
            dst = os.path.join(rdir, "zpacks", f"{pack_hex}.zst")
            try:
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(local_z, dst + ".tmp")
                os.replace(dst + ".tmp", dst)
                os.unlink(local_z)
            except OSError as e:
                log.info("pack %s demotion failed: %s",
                         pack_hex[:12], e)
                return False
            metrics.counter_add(metrics.STORAGE_EVICTIONS,
                                reason="demote_pack")
            events.emit("storage_evict", reason="demote_pack",
                        object=pack_hex, tier="remote")
            return True
        # No compressed twin: materialize the raw pack while its
        # members are still present (the caller demotes packs BEFORE
        # deleting member chunks for exactly this reason).
        rs = self._recipe_store()
        members = rs.pack_members(pack_hex)
        if not members:
            return False
        dst = os.path.join(rdir, "packs", f"{pack_hex}.pack")
        tmp = dst + ".tmp"
        h = hashlib.sha256()
        try:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(tmp, "wb") as out:
                for fp, length in members:
                    # Straight off the chunk files (not the serving
                    # registry — demotion must work offline too); a
                    # pack hex is the sha256 of exactly these bytes
                    # concatenated, verified below before commit.
                    path = os.path.join(self.chunks_dir, fp[:2], fp)
                    with open(path, "rb") as f:
                        data = f.read()
                    if len(data) != int(length):
                        raise ValueError(
                            f"member {fp} is {len(data)} bytes, "
                            f"table says {length}")
                    h.update(data)
                    out.write(data)
            if h.hexdigest() != pack_hex:
                os.unlink(tmp)
                log.warning("pack %s materialization hash mismatch — "
                            "not demoted", pack_hex[:12])
                return False
            os.replace(tmp, dst)
        except (OSError, ValueError) as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            log.info("pack %s materialization failed: %s",
                     pack_hex[:12], e)
            return False
        metrics.counter_add(metrics.STORAGE_EVICTIONS,
                            reason="demote_pack")
        events.emit("storage_evict", reason="demote_pack",
                    object=pack_hex, tier="remote")
        return True

    # -- refetch (promotion) -----------------------------------------

    def refetch_chunks(self, missing, lengths: dict[str, int],
                       put=None) -> set[str]:
        """Promote evicted chunks back into the hot tier from the
        pack/remote tiers: spans map onto seekable-zstd frames (or
        raw-pack runs) through the same planners the ranged wire
        uses, each run's bytes are charged to the transfer engine's
        memory budget, and every carved chunk is digest-verified
        before the CAS stores it. Returns the fps restored."""
        from makisu_tpu_torch.cache.chunks import (ChunkStore,
                                             plan_frame_runs)
        from makisu_tpu_torch.registry import transfer
        from makisu_tpu_torch.utils import zstdio
        index = self.pack_index()
        by_pack: dict[str, list[tuple[int, int, str]]] = {}
        for fp in missing:
            coords = index.get(fp)
            if coords is None:
                continue
            pack_hex, off, length = coords
            by_pack.setdefault(pack_hex, []).append(
                (off, int(lengths.get(fp, length) or length), fp))
        if not by_pack:
            return set()
        if put is None:
            live = _live_chunk_store(self.storage_dir)
            put = live.put if live is not None else self._put_chunk
        budget = transfer.engine().budget
        rs = self._recipe_store()
        restored: set[str] = set()
        moved = 0

        def admit(fp: str, data: bytes) -> None:
            if hashlib.sha256(data).hexdigest() != fp:
                raise ValueError(f"tier refetch for {fp} carved "
                                 f"bytes that do not hash to it")
            put(fp, data)
            restored.add(fp)

        for pack_hex, spans in sorted(by_pack.items()):
            frames = rs.pack_frames(pack_hex)
            zpath = self._local_zpack(pack_hex)
            rz, rraw = self._remote_paths(pack_hex)
            zpath = zpath or rz
            try:
                if frames and zpath and zstdio.available():
                    for run in plan_frame_runs(frames, spans):
                        z_start = run[0][2]
                        z_end = run[-1][2] + run[-1][3]
                        raw_total = sum(r[1] for r in run)
                        with budget.reserve(
                                (z_end - z_start) + raw_total):
                            with open(zpath, "rb") as fh:
                                fh.seek(z_start)
                                zdata = fh.read(z_end - z_start)
                            if len(zdata) != z_end - z_start:
                                raise ValueError(
                                    f"zpack {pack_hex} shorter than "
                                    f"its frame index")
                            for raw_off, raw_len, z_off, z_len in run:
                                zo = z_off - z_start
                                raw = zstdio.decompress(
                                    zdata[zo:zo + z_len], raw_len)
                                for off, length, fp in spans:
                                    if fp in restored:
                                        continue
                                    if off < raw_off or \
                                            off + length > \
                                            raw_off + raw_len:
                                        continue
                                    lo = off - raw_off
                                    admit(fp, raw[lo:lo + length])
                        moved += z_end - z_start
                elif rraw is not None:
                    for start, end, run_spans in _raw_runs(spans):
                        with budget.reserve(end - start):
                            with open(rraw, "rb") as fh:
                                fh.seek(start)
                                data = fh.read(end - start)
                            if len(data) != end - start:
                                raise ValueError(
                                    f"remote pack {pack_hex} shorter "
                                    f"than its table")
                            for off, length, fp in run_spans:
                                if fp in restored:
                                    continue
                                lo = off - start
                                admit(fp, data[lo:lo + length])
                        moved += end - start
            except (OSError, ValueError) as e:
                log.info("tier refetch from pack %s failed: %s",
                         pack_hex[:12], e)
                continue
        if restored:
            metrics.counter_add(metrics.STORAGE_REFETCH_BYTES, moved)
            _count("refetch_bytes", moved)
            _count("refetched_chunks", len(restored))
            events.emit("chunk_fetch", route="tier",
                        fetched=len(restored), requested=len(by_pack),
                        bytes=moved)
            log.info("refetched %d chunk(s) (%d bytes moved) from "
                     "the pack/remote tier", len(restored), moved)
        return restored

    def _put_chunk(self, fp: str, data: bytes) -> None:
        """Offline CAS write (no live store registered): same shard
        layout, atomic tmp+rename, digest already verified."""
        shard = os.path.join(self.chunks_dir, fp[:2])
        os.makedirs(shard, exist_ok=True)
        fileio.write_bytes_atomic(os.path.join(shard, fp), data)

    # -- eviction ----------------------------------------------------

    def plan(self, budget_bytes: int | None = None,
             max_itemized: int = 50,
             include_candidates: bool = False) -> dict:
        budget = self.budget_bytes if budget_bytes is None \
            else budget_bytes
        rows = collect_rows(self.storage_dir)
        return policy_for(self.storage_dir).plan(
            rows, budget, max_itemized=max_itemized,
            include_candidates=include_candidates)

    def evict(self, budget_bytes: int | None = None) -> dict:
        """Execute the policy's plan: demote recoverable chunks
        (delete the raw file; the pack tier keeps the bytes), evict
        the rest, then demote cold zpacks to the remote tier while
        the hot+pack total still exceeds the budget. Pins are
        re-checked at deletion time — a read that started after the
        plan was cut still wins."""
        budget = self.budget_bytes if budget_bytes is None \
            else budget_bytes
        if budget <= 0:
            return {"skipped": "unbudgeted"}
        plan = self.plan(budget_bytes=budget, include_candidates=True)
        live = _live_chunk_store(self.storage_dir)
        index = self.pack_index()
        # Demote packs BEFORE deleting member chunks: a raw-pack
        # materialization needs the members present.
        if self.remote_dir:
            packs_needed: set[str] = set()
            for plane, name, _, action, _ in plan["candidates"]:
                if plane != "chunks" or action != "demote":
                    continue
                coords = index.get(name)
                if coords and not self._local_zpack(coords[0]) \
                        and not any(self._remote_paths(coords[0])):
                    packs_needed.add(coords[0])
            for pack_hex in sorted(packs_needed):
                self.demote_pack(pack_hex)
        freed = 0
        evicted = 0
        reasons: dict[str, int] = {}
        for plane, name, size, action, reason in plan["candidates"]:
            if self.board.is_pinned(plane, name):
                continue  # pinned since the plan was cut: it wins
            if plane == "chunks" and action == "demote":
                coords = index.get(name)
                if not (coords
                        and self.pack_recoverable(coords[0])):
                    # The pre-pass couldn't land this pack on a tier:
                    # plain eviction, honestly labeled.
                    reason = "lru" if reason == "demote" else reason
            try:
                if plane == "chunks" and live is not None:
                    live.cas.delete(name)
                else:
                    root = (self.chunks_dir if plane == "chunks"
                            else self.layers_dir)
                    os.unlink(os.path.join(root, name[:2], name))
            except OSError:
                continue
            freed += size
            evicted += 1
            reasons[reason] = reasons.get(reason, 0) + 1
            metrics.counter_add(metrics.STORAGE_EVICTIONS,
                                reason=reason)
        # Cold-pack demotion: compressed twins follow once the hot
        # tier alone cannot meet the budget (hot + pack is this
        # store's real disk footprint).
        packs_demoted = 0
        if self.remote_dir:
            tiers = self.tier_bytes(publish=False)
            excess = (tiers["hot"] + tiers["pack"]) - budget
            if excess > 0:
                zrows = []
                try:
                    with os.scandir(self.zpacks_dir) as entries:
                        for e in entries:
                            if not e.name.endswith(".zst"):
                                continue
                            try:
                                st = e.stat()
                            except OSError:
                                continue
                            zrows.append((st.st_mtime, st.st_size,
                                          e.name[:-len(".zst")]))
                except OSError:
                    zrows = []
                zrows.sort()  # coldest twin first
                for _, zsize, pack_hex in zrows:
                    if excess <= 0:
                        break
                    if self.demote_pack(pack_hex):
                        packs_demoted += 1
                        excess -= zsize
        if evicted or packs_demoted:
            _count("evictions", evicted + packs_demoted)
            _count("evicted_bytes", freed)
            events.emit("storage_evict_pass",
                        storage_dir=self.storage_dir, evicted=evicted,
                        freed_bytes=freed, reasons=reasons,
                        packs_demoted=packs_demoted,
                        pinned_skipped=plan["pinned_skipped"])
            log.info("evicted %d object(s) (%d bytes, %s) + %d "
                     "pack(s) demoted under budget %d",
                     evicted, freed, reasons or "none", packs_demoted,
                     budget)
        self.tier_bytes(publish=True)
        result = {
            "budget_bytes": budget,
            "evicted": evicted,
            "freed_bytes": freed,
            "reasons": reasons,
            "packs_demoted": packs_demoted,
            "pinned_skipped": plan["pinned_skipped"],
            "remaining_bytes": plan["remaining_bytes"],
            "ts": time.time(),
        }
        with self._mu:
            self._last_eviction = result
        return result

    def maybe_evict(self) -> dict | None:
        """Throttled evict: no-op while unbudgeted or inside the
        min interval. Called at build end and from the worker's scrub
        loop — never from a read path."""
        if self.budget_bytes <= 0:
            return None
        now = time.monotonic()
        interval = evict_interval_seconds()
        with self._mu:
            if interval > 0 and \
                    now - self._last_evict_mono < interval:
                return None
            self._last_evict_mono = now
        try:
            return self.evict()
        except Exception as e:  # noqa: BLE001 - never fails a build
            log.info("eviction pass failed for %s: %s",
                     self.storage_dir, e)
            return None

    def describe(self) -> dict:
        """The /storage payload's ``contentstore`` section."""
        with self._mu:
            last = dict(self._last_eviction)
        return {
            "budget_bytes": self.budget_bytes,
            "remote_tier": self.remote_dir or "",
            "tiers": self.tier_bytes(publish=False),
            "pins": self.board.count(),
            "snapshot_pinned_chunks": len(
                snapshot_pinned_chunks(self.storage_dir)),
            "counters": counters(),
            "last_eviction": last,
        }


def _raw_runs(spans: list[tuple[int, int, str]], gap: int | None = None
              ) -> list[tuple[int, int, list[tuple[int, int, str]]]]:
    """Coalesce raw-pack spans into ranged runs (same gap economics
    as the wire planners): [(start, end, spans_in_run)]."""
    from makisu_tpu_torch.cache.chunks import ChunkStore
    if gap is None:
        gap = ChunkStore.PACK_RUN_GAP
    runs: list[tuple[int, int, list[tuple[int, int, str]]]] = []
    for span in sorted(spans):
        off, length, _fp = span
        if runs and off - runs[-1][1] <= gap:
            start, _, members = runs.pop()
            runs.append((start, off + length, members + [span]))
        else:
            runs.append((off, off + length, [span]))
    return runs


# -- process registry --------------------------------------------------------

_stores_mu = threading.Lock()
_stores: dict[str, ContentStore] = {}


def store_for(storage_dir: str) -> ContentStore:
    key = os.path.realpath(storage_dir)
    with _stores_mu:
        store = _stores.get(key)
        if store is None:
            store = _stores[key] = ContentStore(key)
        return store


def refetch_for_chunk_root(chunk_root: str, missing,
                           lengths: dict[str, int],
                           put=None) -> set[str]:
    """``ChunkStore.ensure_available``'s tier hook: promote what the
    local pack/remote tiers can recover before peers or the registry
    are consulted. Free no-op when the storage has no serve plane."""
    storage_dir = storage_dir_for_chunk_root(chunk_root)
    if not os.path.isdir(os.path.join(storage_dir, "serve")):
        return set()
    try:
        return store_for(storage_dir).refetch_chunks(
            missing, lengths, put=put)
    except Exception as e:  # noqa: BLE001 - a tier miss never fails
        log.debug("tier refetch unavailable for %s: %s",
                  storage_dir, e)
        return set()
