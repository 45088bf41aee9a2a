"""Build telemetry: counters, gauges, histograms, and a span tracer.

Two scopes, mirroring the per-build ``_build_sink`` pattern in
``utils/logging.py``:

- A process-global registry that aggregates everything the process has
  done (what the worker's ``GET /metrics`` Prometheus endpoint serves —
  a scraper wants process totals, not one request's).
- An optional contextvar-bound per-build registry: every counter/gauge/
  histogram write lands in BOTH, and spans attach to the innermost
  bound registry. Threads a build spawns (shell drains, async cache
  pushes, chunk uploads) carry the context along via
  ``contextvars.copy_context``, so concurrent worker builds never mix
  telemetry — the same isolation guarantee the log sinks give.

The span tree is the per-build wall-clock breakdown (``--metrics-out``
writes it as JSON); counters answer rate questions (cache hit ratio,
bytes hashed per backend, registry transfer volume).

Everything here is stdlib-only and import-cycle-free, so any module in
the tree can instrument itself. Telemetry must never fail a build:
writes are cheap dict updates under a lock, and the public helpers
swallow nothing — they simply cannot raise on well-formed names.

Copy of ``makisu_tpu/utils/metrics.py``, with the same series names,
label keys and report schema, so either package's renderers read the
other's reports. The registry and its contextvars are this package's
own: a port build never touches the reference's global registry. The
fleet, serve and storage name constants are copied as names only;
nothing in the port emits them until those planes are ported.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Any, Iterator

from makisu_tpu_torch.utils import events

_LabelKey = tuple[tuple[str, str], ...]

# Histogram buckets default to a duration ladder (seconds); metrics
# with a different shape (batch sizes, fill counts) pass their own on
# first observation.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0)

# The layer-commit pipeline's per-stage telemetry (read_ahead, gear_scan,
# chunk_sha, compress, tar_write). One name pair shared by every stage —
# and by the `makisu-tpu report` bottleneck section — so the series can
# never drift apart.
COMMIT_STAGE_BUSY = "makisu_commit_stage_busy_seconds"
COMMIT_QUEUE_DEPTH = "makisu_commit_queue_depth"

# The compress stage's label under the stage pair above, plus the
# block-parallel stage's own series (tario.BlockGzipWriter and the
# LayerSink compression worker share the label; the block/byte counters
# label backend=zlib|pgzip so the bench compress_micro section and the
# report can split the two formats).
COMPRESS_STAGE = "compress"
COMPRESS_BLOCKS = "makisu_compress_blocks_total"
COMPRESS_BYTES = "makisu_compress_bytes_total"

# Device execution telemetry (ops/backend.py note_device_dispatch):
# one name set shared by the HashService, the chunker's lane batcher,
# the /healthz device section, and the docs' metric table — per lane
# bucket: the host's wait for a launch's digests (not the card's time),
# first-dispatch (compile) cost, bytes shipped host→device, and
# padded−real waste inside filled lanes (the port ships no padding and
# writes none; the name is the reference's).
DEVICE_DISPATCH_SECONDS = "makisu_device_dispatch_seconds"
DEVICE_COMPILE_SECONDS = "makisu_device_compile_seconds"
DEVICE_H2D_BYTES = "makisu_device_h2d_bytes_total"
DEVICE_PADDING_WASTE = "makisu_device_padding_waste_bytes_total"
# The device plane's bounded host waits (ops/backend.py sync_bounded):
# seconds per wait, and waits by result (ok|timeout|error).
DEVICE_SYNC_SECONDS = "makisu_device_sync_seconds"
DEVICE_SYNC_TOTAL = "makisu_device_sync_total"
# The card's own time: kernel seconds between CUDA timing events
# recorded around each launch, labelled kernel=gear_bitmap|sha256_spans
# (a chunk session's launches) or sha256_multi (the hash service's).
# Port only; copies are not counted.
DEVICE_BUSY_SECONDS = "makisu_device_busy_seconds_total"

# Spans only the port opens (the reference's tree lacks them): parts of
# a layer commit (the diff against the tree: the copy-op diff or the
# scan's walk), the chunk index of a layer, and one span per KV
# attempt. Each name falls in the phase of the span it nests in
# (``traceexport.phase_of``), so phase totals keep their meaning.
PORT_SPANS = ("commit.diff", "commit.mtime_wait", "commit.tar_write",
              "commit.sink_finish", "index_layer", "kv_pull", "kv_push")
# Layer commits by whether the mtime wait slept (outcome=waited) or the
# layer's newest mtime second had already passed (outcome=skipped;
# snapshot/memfs.py _sync). Port only: the reference always waits.
COMMIT_MTIME_WAITS = "makisu_commit_mtime_waits_total"
# Entries written into layer tars (files, directories, symlinks and
# whiteouts), added once per layer commit (snapshot/memfs.py
# _commit_layer). Port only.
COMMIT_ENTRIES = "makisu_commit_entries_total"
# The chunk store's dedup existence answers (cache/chunks.py: the pool's
# probe batches and index_layer), by route: from the window's listing
# of the digest's CAS shard (route=listing) or a stat (route=stat); and
# the shard listings taken. Port only.
CHUNK_PROBES = "makisu_chunk_probes_total"
CHUNK_SHARD_LISTINGS = "makisu_chunk_shard_listings_total"
# Counters only the port writes (beside the makisu_device_* series).
PORT_COUNTERS = (COMMIT_MTIME_WAITS, COMMIT_ENTRIES, CHUNK_PROBES,
                 CHUNK_SHARD_LISTINGS)

# The shared hash service (chunker/service.py): one S1 launch per batch
# of ring passes from concurrent builds. Fill counts the passes of a
# launch; occupancy is fill / the service's largest batch (passes per
# launch), not a lane capacity (the port has none). Linger is how long
# the dispatcher waited for more passes, queue depth the passes left
# waiting after it took a batch.
HASH_BATCHES = "makisu_hash_batches_total"
HASH_CROSS_BUILD_BATCHES = "makisu_hash_cross_build_batches_total"
HASH_BATCH_SECONDS = "makisu_hash_batch_seconds"
HASH_BATCH_FILL = "makisu_hash_batch_fill"
HASH_BATCH_OCCUPANCY = "makisu_hash_batch_occupancy"
HASH_BATCH_LINGER = "makisu_hash_batch_linger_seconds"
HASH_QUEUE_DEPTH = "makisu_hash_queue_depth"
HASH_BATCH_FAILURES = "makisu_hash_batch_failures_total"

# Fleet telemetry (makisu_tpu_torch/fleet/): one name set shared by the
# scheduler, the peer-exchange module, the worker's /chunks endpoint,
# loadgen's fleet report, and the docs' metric table. Routing verdicts
# label makisu_fleet_route_total (affinity|spillover|failover|
# quota_denied); the peer counters count CHUNKS served worker-to-worker
# before any registry round trip.
FLEET_ROUTE_TOTAL = "makisu_fleet_route_total"
FLEET_WORKERS = "makisu_fleet_workers"
FLEET_FRONTDOOR_QUEUE = "makisu_fleet_frontdoor_queue_depth"
FLEET_INFLIGHT_BUILDS = "makisu_fleet_inflight_builds"
FLEET_TENANT_INFLIGHT = "makisu_fleet_tenant_inflight"
FLEET_QUOTA_WAIT = "makisu_fleet_quota_wait_seconds"
FLEET_RETRIES = "makisu_fleet_build_retries_total"
FLEET_BUILD_LATENCY = "makisu_fleet_build_latency_seconds"
FLEET_PEER_CHUNK_HITS = "makisu_fleet_peer_chunk_hits_total"
FLEET_PEER_CHUNK_MISSES = "makisu_fleet_peer_chunk_misses_total"
FLEET_PEER_CHUNK_BYTES = "makisu_fleet_peer_chunk_bytes_total"
FLEET_PEER_MAP_VERSION = "makisu_fleet_peer_map_version"
FLEET_CHUNK_SERVES = "makisu_fleet_chunk_serves_total"
FLEET_CHUNK_SERVE_BYTES = "makisu_fleet_chunk_serve_bytes_total"

# Chunk-native distribution plane (makisu_tpu_torch/serve/): one name set
# shared by the recipe store, the serve/worker endpoints, the delta-pull
# client, the peer pack exchange, loadgen's fleet report, and the docs'
# metric table. Recipe/pack request counters label result/kind; the
# delta byte counters split a pull's economics into wire-fetched vs
# locally-reused bytes.
SERVE_RECIPES_PUBLISHED = "makisu_serve_recipes_published_total"
SERVE_RECIPE_REQUESTS = "makisu_serve_recipe_requests_total"
SERVE_PACK_REQUESTS = "makisu_serve_pack_requests_total"
SERVE_PACK_BYTES = "makisu_serve_pack_bytes_total"
SERVE_DELTA_PULLS = "makisu_serve_delta_pulls_total"
SERVE_DELTA_BYTES = "makisu_serve_delta_bytes_total"
SERVE_PEER_PACK_REQUESTS = "makisu_serve_peer_pack_requests_total"
SERVE_PEER_PACK_BYTES = "makisu_serve_peer_pack_bytes_total"
# Seekable-zstd pack plane: independently-decompressible frames served
# (the /zpacks endpoint), and wire bytes split by encoding — the
# raw-vs-compressed economics the delta-pull smoke gates on
# (encoding=raw|zstd, counted client-side as fetched and server-side
# as served).
SERVE_PACK_FRAMES = "makisu_serve_pack_frames_total"
SERVE_WIRE_BYTES = "makisu_serve_wire_bytes_total"

# Deploy-identity info gauge (cli.main): constant 1, identity in the
# labels — the node_exporter "build_info" idiom.
BUILD_INFO = "makisu_build_info"

# Registry transfer plane (registry/client.py): bytes/blobs count the
# wire in both directions; retries label the retried operation.
REGISTRY_BYTES_TOTAL = "makisu_registry_bytes_total"
REGISTRY_BLOBS_TOTAL = "makisu_registry_blobs_total"
REGISTRY_RETRIES_TOTAL = "makisu_registry_retries_total"

# HTTP transport (utils/httputil.py): requests vs fresh connections —
# the keep-alive reuse ratio CI's transfer smoke asserts on.
HTTP_REQUESTS_TOTAL = "makisu_http_requests_total"
HTTP_CONNECTIONS_TOTAL = "makisu_http_connections_total"

# Process resource gauges (utils/resources.py sampler): what the
# worker's /metrics scrape sees between builds.
PROCESS_RSS_BYTES = "makisu_process_rss_bytes"
PROCESS_CPU_SECONDS = "makisu_process_cpu_seconds"
PROCESS_THREADS = "makisu_process_threads"
PROCESS_OPEN_FDS = "makisu_process_open_fds"
PROCESS_IO_READ_BYTES = "makisu_process_io_read_bytes"
PROCESS_IO_WRITE_BYTES = "makisu_process_io_write_bytes"

# Build-plan execution (builder/plan.py, builder/node.py).
STAGES_TOTAL = "makisu_stages_total"
CACHED_LAYERS_APPLIED_TOTAL = "makisu_cached_layers_applied_total"

# Resident build sessions (worker/session.py): reuse hits, dirty-set
# invalidations by reason, and resident memo bytes per context.
SESSION_HITS = "makisu_session_hits"
SESSION_INVALIDATIONS = "makisu_session_invalidations_total"
SESSION_RESIDENT_BYTES = "makisu_session_resident_bytes"

# Chunk-addressed session snapshots (worker/snapshots.py): checkpoint
# writes (result=ok|error), chunk bytes pushed into the CAS split by
# result=written|reused (the O(changed) incremental-write economics),
# and restore attempts labeled result=ok|refused|error — refusals
# carry the invalidation reason (flag_identity|isa_change|stale|...)
# so a fleet that silently falls back to cold rebuilds still pages.
SESSION_SNAPSHOT_WRITES = "makisu_session_snapshot_writes_total"
SESSION_SNAPSHOT_CHUNK_BYTES = "makisu_session_snapshot_chunk_bytes_total"
SESSION_SNAPSHOT_RESTORES = "makisu_session_snapshot_restores_total"

# Fleet-wide trace stitching: inbound traceparent adoption outcomes
# (result=adopted|malformed — a malformed header mints fresh ids and
# is COUNTED, never crashed on), and the front door's aggregated
# /metrics fan-out (result=ok|error per worker scrape).
TRACE_ADOPTED = "makisu_trace_adopted_total"
FLEET_AGGREGATED_SCRAPES = "makisu_fleet_aggregated_scrapes_total"

# Serve access ledger (serve/server.py AccessLog): per-request rows
# keyed by the inbound traceparent, the cross-process half of a peer/
# delta fetch's trace. The counter tallies rows by kind so the ring's
# churn is visible on /metrics.
SERVE_ACCESS_TOTAL = "makisu_serve_access_total"

# Storage observability plane (cache/census.py): per-plane census
# gauges (plane=blobs|chunks|packs|recipes), per-tenant attribution
# (tenant labels capped via census.cap_label), audit findings by kind,
# and the sampled integrity scrub's progress/corruption counters.
STORAGE_BYTES = "makisu_storage_bytes"
STORAGE_OBJECTS = "makisu_storage_objects"
STORAGE_TENANT_BYTES = "makisu_storage_tenant_bytes"
STORAGE_FINDINGS = "makisu_storage_findings"
STORAGE_CENSUS_RUNS = "makisu_storage_census_runs_total"
STORAGE_SCRUB_CHUNKS = "makisu_storage_scrub_chunks_total"
STORAGE_SCRUB_BYTES = "makisu_storage_scrub_bytes_total"
STORAGE_SCRUB_CORRUPT = "makisu_storage_scrub_corrupt_total"

# Storage mechanism plane (storage/contentstore.py): the budget
# evictor's victims by reason (lru|quota|demote|demote_pack), per-tier
# byte gauges (tier=hot|pack|remote), and bytes moved back by
# pack-tier refetch promotions.
STORAGE_EVICTIONS = "makisu_storage_evictions_total"
STORAGE_TIER_BYTES = "makisu_storage_tier_bytes"
STORAGE_REFETCH_BYTES = "makisu_storage_refetch_bytes_total"

# Fleet SLO plane (fleet/slo.py + utils/alerts.py): alert lifecycle
# counters (labeled rule/severity), the active-alert gauge a threshold
# rule or dashboard reads directly, webhook delivery outcomes
# (result=ok|error), synthetic canary build outcomes
# (worker + result=ok|error) and latency, the per-worker health score
# the scheduler's demotion reads, and the scrape-fan-out liveness
# gauge (1/0 per worker) on the aggregated fleet /metrics.
ALERTS_FIRED = "makisu_alerts_fired_total"
ALERTS_RESOLVED = "makisu_alerts_resolved_total"
ALERT_ACTIVE = "makisu_alert_active"
ALERT_WEBHOOK = "makisu_alert_webhook_total"
CANARY_BUILDS = "makisu_canary_builds_total"
CANARY_LATENCY = "makisu_canary_latency_seconds"
WORKER_HEALTH_SCORE = "makisu_worker_health_score"
WORKER_UP = "makisu_worker_up"

# Continuous profiling plane: the wall-clock sampler's own vitals —
# cumulative samples, folded stacks dropped at the bounded-memory cap,
# distinct stacks held, and the self-measured overhead fraction the
# <2% budget is judged against. Exported ~1/s from the sampler thread.
PROFILER_SAMPLES = "makisu_profiler_samples_total"
PROFILER_DROPPED = "makisu_profiler_dropped_total"
PROFILER_STACKS = "makisu_profiler_distinct_stacks"
PROFILER_OVERHEAD = "makisu_profiler_overhead_ratio"


def stage_busy_add(stage: str, seconds: float) -> None:
    """Charge ``seconds`` of busy time to one commit-pipeline stage.
    Callers accumulate locally and flush per batch/close — never per
    chunk — so the accounting can't become the overhead it measures."""
    counter_add(COMMIT_STAGE_BUSY, seconds, stage=stage)


def stage_queue_depth(stage: str, depth: int) -> None:
    gauge_set(COMMIT_QUEUE_DEPTH, depth, stage=stage)


def _label_key(labels: dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _nearest_rank(ordered, p: float) -> float:
    rank = max(int(len(ordered) * p / 100.0 + 0.5), 1)
    return ordered[min(rank, len(ordered)) - 1]


def percentile(values, p: float) -> float:
    """Nearest-rank percentile of a sequence (p in [0, 100]). One
    definition shared by the worker's queue stats, loadgen's report,
    the history trends, and bench's warm-rebuild rounds — four
    consumers quoting p50/p99 must agree on what those mean. Raises
    on an empty sequence (callers gate on count)."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of an empty sequence")
    return _nearest_rank(ordered, p)


def percentile_stats(values) -> dict[str, float]:
    """``{"count", "p50", "p90", "p99", "max"}`` of a sequence —
    the latency digest every load-observability surface exports
    (``/healthz`` queue section, ``/builds``, loadgen reports,
    ``history`` trends). Empty input yields ``{"count": 0}``. One
    sort serves all three ranks."""
    ordered = sorted(values)
    if not ordered:
        return {"count": 0}
    return {
        "count": len(ordered),
        "p50": round(_nearest_rank(ordered, 50), 6),
        "p90": round(_nearest_rank(ordered, 90), 6),
        "p99": round(_nearest_rank(ordered, 99), 6),
        "max": round(ordered[-1], 6),
    }


def new_id(nbytes: int) -> str:
    """Random lowercase-hex identifier of ``2 * nbytes`` characters.
    W3C trace ids are 16 bytes, span ids 8 (trace-context §3.2.2.3-4)."""
    return os.urandom(nbytes).hex()


def parse_traceparent(value: str) -> tuple[str, str] | None:
    """Validate a W3C ``traceparent`` header value and return
    ``(trace_id, parent_span_id)``, or ``None`` for anything
    malformed. Strict by the spec's §3.2: four dash-separated fields,
    a known 2-hex version (``ff`` is reserved-invalid), 32/16
    lowercase-hex ids, neither all-zero, a 2-hex flags field. Callers
    MUST mint fresh ids on ``None`` — a bad header from a buggy proxy
    can cost stitching, never a build."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    hexdigits = set("0123456789abcdef")
    for field, width in ((version, 2), (trace_id, 32),
                         (span_id, 16), (flags, 2)):
        if len(field) != width or not set(field) <= hexdigits:
            return None
    if version == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


# Inbound trace context for the NEXT registry this context creates:
# the worker's /build handler (and anything else accepting a build on
# behalf of an upstream caller) binds the raw traceparent here, and
# ``cli.main`` adopts it into the build's fresh registry — so the
# front door's forward span, the worker's build spans, and every
# outbound request the build issues share ONE trace id.
_inbound_traceparent: "contextvars.ContextVar[str]" = \
    contextvars.ContextVar("makisu_torch_inbound_traceparent", default="")


def bind_inbound_traceparent(value: str):
    """Bind a raw inbound ``traceparent`` in the current context
    (validated only at adoption time). Returns a reset token."""
    return _inbound_traceparent.set(value or "")


def reset_inbound_traceparent(token) -> None:
    _inbound_traceparent.reset(token)


def inbound_traceparent() -> str:
    return _inbound_traceparent.get()


def adopt_inbound(registry: "MetricsRegistry", value: str) -> str:
    """Adopt a raw inbound traceparent into ``registry`` — THE
    adoption policy, shared by ``cli.main`` and the fleet forwarder so
    the semantics (and the ``makisu_trace_adopted_total`` counting)
    can never diverge between the two doors. Returns ``"adopted"``,
    ``"malformed"`` (fresh ids kept, counted), or ``""`` (no inbound
    value at all)."""
    if not value:
        return ""
    parsed = parse_traceparent(value)
    if parsed is None:
        _global.counter_add(TRACE_ADOPTED, result="malformed")
        return "malformed"
    registry.adopt_trace(*parsed)
    _global.counter_add(TRACE_ADOPTED, result="adopted")
    return "adopted"


class Span:
    """One timed operation; children nest via the context variable.

    Every span carries a W3C-shaped 64-bit span id and its parent's, so
    the tree exports losslessly (Perfetto, the event stream) and the
    ``traceparent`` header on outbound HTTP names the exact span that
    issued the request."""

    __slots__ = ("name", "attrs", "start_unix", "duration", "error",
                 "children", "registry", "span_id", "parent_id", "_t0",
                 "peak_rss", "cpu_seconds")

    def __init__(self, name: str, attrs: dict[str, Any],
                 registry: "MetricsRegistry") -> None:
        self.name = name
        self.attrs = {k: str(v) for k, v in attrs.items()}
        self.start_unix = time.time()
        self._t0 = time.monotonic()
        self.duration: float | None = None  # None while still open
        self.error: str | None = None
        self.children: list[Span] = []
        self.registry = registry
        self.span_id = new_id(8)
        self.parent_id = ""
        # Filled by the resource sampler (utils/resources.py) while the
        # span is open: peak process RSS observed, and the CPU seconds
        # charged to this span while it was an open LEAF. None = never
        # sampled (sampler off, or span shorter than the interval).
        self.peak_rss: int | None = None
        self.cpu_seconds = 0.0

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "name": self.name,
            "span_id": self.span_id,
            "start": round(self.start_unix, 6),
            "duration": (round(self.duration, 6)
                         if self.duration is not None else None),
        }
        if self.parent_id:
            out["parent_id"] = self.parent_id
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.error:
            out["error"] = self.error
        if self.peak_rss is not None:
            out["resources"] = {
                "peak_rss_bytes": int(self.peak_rss),
                "cpu_seconds": round(self.cpu_seconds, 6),
            }
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class _Hist:
    __slots__ = ("count", "sum", "min", "max", "buckets", "bucket_counts")

    def __init__(self, buckets: tuple[float, ...]) -> None:
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self.buckets = buckets
        self.bucket_counts = [0] * len(buckets)

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        # bucket_counts are per-bucket (NON-cumulative); the Prometheus
        # renderer prefix-sums them into the cumulative form.
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.bucket_counts[i] += 1
                break


class MetricsRegistry:
    """Counters/gauges/histograms plus a span-tree root. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, dict[_LabelKey, float]] = {}
        self._gauges: dict[str, dict[_LabelKey, float]] = {}
        self._hists: dict[str, dict[_LabelKey, _Hist]] = {}
        # One 128-bit trace id per registry: every span in this
        # registry's tree — and every traceparent header a request in
        # its context carries — shares it, so a build's outbound HTTP
        # is correlatable with registry/KV server logs.
        self.trace_id = new_id(16)
        self.root = Span("root", {}, self)

    def adopt_trace(self, trace_id: str, parent_span_id: str) -> None:
        """Adopt an upstream trace context (a validated traceparent):
        this registry's spans join the caller's trace instead of
        minting a fresh one. The ROOT span takes the caller's span id,
        so the first real span this registry opens carries
        ``parent_id = <caller's span>`` — the cross-process stitch a
        merged trace assembles on. Call before any span opens (the
        adoption point in ``cli.main`` is right after the registry is
        bound)."""
        self.trace_id = trace_id
        self.root.span_id = parent_span_id

    # -- writes -----------------------------------------------------------

    def counter_add(self, name: str, value: float = 1.0,
                    **labels: Any) -> None:
        key = _label_key(labels)
        # Signal-context callers (FlightRecorder.dump) PROBE this lock
        # with a timeout first and skip the bump when it is held — see
        # the `for reg in metrics._targets()` guard in dump().
        # check: allow(signal-safety)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float, **labels: Any) -> None:
        with self._lock:
            self._gauges.setdefault(name, {})[_label_key(labels)] = \
                float(value)

    def observe(self, name: str, value: float,
                buckets: tuple[float, ...] | None = None,
                **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            series = self._hists.setdefault(name, {})
            hist = series.get(key)
            if hist is None:
                hist = series[key] = _Hist(buckets or DEFAULT_BUCKETS)
            hist.observe(value)

    def observe_batch(self, name: str, values,
                      buckets: tuple[float, ...] | None = None,
                      **labels: Any) -> None:
        """Fold a whole batch of observations into one histogram under
        ONE lock acquisition. The per-value path costs a lock + label
        sort each; a 4GB layer has ~500k chunk sizes to observe, which
        must not become the overhead the histogram exists to measure.
        Binning runs outside the lock."""
        values = list(values)
        if not values:
            return
        use = buckets or DEFAULT_BUCKETS
        import bisect
        binned = [0] * len(use)
        for v in values:
            i = bisect.bisect_left(use, v)
            if i < len(use):
                binned[i] += 1
        total, lo, hi = float(sum(values)), min(values), max(values)
        key = _label_key(labels)
        with self._lock:
            series = self._hists.setdefault(name, {})
            hist = series.get(key)
            if hist is None:
                hist = series[key] = _Hist(use)
            hist.count += len(values)
            hist.sum += total
            hist.min = lo if hist.min is None else min(hist.min, lo)
            hist.max = hi if hist.max is None else max(hist.max, hi)
            if hist.buckets == use:
                for i, n in enumerate(binned):
                    hist.bucket_counts[i] += n
            else:  # first observer picked other buckets; re-bin to its
                for v in values:
                    for i, le in enumerate(hist.buckets):
                        if v <= le:
                            hist.bucket_counts[i] += 1
                            break

    # -- reads ------------------------------------------------------------

    def counter_total(self, name: str, **labels: Any) -> float:
        """Sum of every series of ``name`` whose labels are a superset
        of the given ones (no labels: the metric's grand total)."""
        want = set(_label_key(labels))
        with self._lock:
            series = self._counters.get(name, {})
            return sum(v for k, v in series.items() if want <= set(k))

    def gauge_value(self, name: str, default: float = 0.0,
                    **labels: Any) -> float:
        """Current value of one gauge series (exact label match; no
        labels reads the unlabeled series). What the worker's
        ``/healthz`` uses to surface transfer-engine gauges without a
        Prometheus scrape."""
        with self._lock:
            return self._gauges.get(name, {}).get(
                _label_key(labels), default)

    def counter_by_label(self, name: str, label: str) -> dict[str, float]:
        """Grand total of ``name`` broken down by one label's values."""
        out: dict[str, float] = {}
        with self._lock:
            for key, value in self._counters.get(name, {}).items():
                for k, v in key:
                    if k == label:
                        out[v] = out.get(v, 0.0) + value
        return out

    def report(self) -> dict[str, Any]:
        """JSON-ready build report: span tree + every metric series."""

        def series_list(table: dict[str, dict[_LabelKey, float]]):
            return {
                name: [{"labels": dict(key), "value": value}
                       for key, value in sorted(series.items())]
                for name, series in sorted(table.items())
            }

        # Signal-context callers reach report() only through
        # flightrecorder._metrics_snapshot, which probes this lock with
        # a timeout and ships the bundle without a metrics section when
        # it is held.  # check: allow(signal-safety)
        with self._lock:
            hists = {
                name: [{
                    "labels": dict(key),
                    "count": h.count,
                    "sum": round(h.sum, 6),
                    "min": h.min,
                    "max": h.max,
                } for key, h in sorted(series.items())]
                for name, series in sorted(self._hists.items())
            }
            counters = series_list(self._counters)
            gauges = series_list(self._gauges)
            spans = [c.to_dict() for c in self.root.children]
        return {
            "schema": "makisu-tpu.metrics.v1",
            "trace_id": self.trace_id,
            "spans": spans,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }


# -- scoping ---------------------------------------------------------------

_global = MetricsRegistry()

_build_registry: "contextvars.ContextVar[MetricsRegistry | None]" = \
    contextvars.ContextVar("makisu_torch_build_metrics", default=None)
_current_span: "contextvars.ContextVar[Span | None]" = \
    contextvars.ContextVar("makisu_torch_current_span", default=None)


def global_registry() -> MetricsRegistry:
    return _global


def set_build_registry(registry: MetricsRegistry | None):
    """Bind a per-context registry (worker mode: one per /build).
    Returns a token for ``reset_build_registry``."""
    return _build_registry.set(registry)


def reset_build_registry(token) -> None:
    _build_registry.reset(token)


def active_registry() -> MetricsRegistry:
    return _build_registry.get() or _global


def _targets() -> tuple[MetricsRegistry, ...]:
    bound = _build_registry.get()
    if bound is None or bound is _global:
        return (_global,)
    return (_global, bound)


# Every span open in the process, across all registries: the resource
# sampler attributes RSS/CPU to these, and the flight recorder snapshots
# them (with ages) into diagnostic bundles. A plain dict keyed by id():
# single-item inserts/deletes are atomic under the GIL, so readers —
# including a SIGTERM handler that interrupted arbitrary code — never
# need a lock that the interrupted frame might hold.
_open_spans: dict[int, Span] = {}


def snapshot_concurrent(container) -> list:
    """``list(container)`` against a structure other threads mutate
    WITHOUT taking a lock: retried on the RuntimeError a concurrent
    resize raises, empty after four straight losses. The forensics
    paths (signal handlers included) read every shared structure this
    way — a lock the interrupted frame might hold must never be
    taken."""
    for _ in range(4):
        try:
            return list(container)
        except RuntimeError:  # mutated mid-iteration; retry
            continue
    return []  # pragma: no cover - four consecutive races


def open_span_snapshot() -> list[dict[str, Any]]:
    """Every open span as a JSON-ready dict with its age, sorted
    oldest-first. ``leaf`` marks spans with no open child — where the
    build actually is. Lock-free (retried on concurrent mutation) so
    the flight recorder can call it from a signal handler."""
    spans = snapshot_concurrent(_open_spans.values())
    now = time.monotonic()
    parent_ids = {s.parent_id for s in spans}
    out = []
    for s in spans:
        out.append({
            "name": s.name,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "trace_id": s.registry.trace_id,
            "start": round(s.start_unix, 6),
            "age_seconds": round(now - s._t0, 3),
            "attrs": dict(s.attrs),
            "leaf": s.span_id not in parent_ids,
        })
    out.sort(key=lambda d: -d["age_seconds"])
    return out


def attribute_resource_sample(rss_bytes: int, cpu_delta: float) -> None:
    """Charge one resource sample to the open spans: every open span
    tracks the peak RSS observed while it was open; the CPU burned
    since the previous sample is split evenly across the open LEAF
    spans (concurrent builds share the process's CPU — an even split
    is the honest default). Called by ``utils/resources.py``."""
    spans = snapshot_concurrent(_open_spans.values())
    if not spans:
        return
    parent_ids = {s.parent_id for s in spans}
    leaves = [s for s in spans if s.span_id not in parent_ids]
    share = cpu_delta / len(leaves) if leaves else 0.0
    for s in spans:
        if s.peak_rss is None or rss_bytes > s.peak_rss:
            s.peak_rss = rss_bytes
    for s in leaves:
        s.cpu_seconds += share


def counter_add(name: str, value: float = 1.0, **labels: Any) -> None:
    for reg in _targets():
        reg.counter_add(name, value, **labels)


def gauge_set(name: str, value: float, **labels: Any) -> None:
    for reg in _targets():
        reg.gauge_set(name, value, **labels)


def observe(name: str, value: float,
            buckets: tuple[float, ...] | None = None,
            **labels: Any) -> None:
    for reg in _targets():
        reg.observe(name, value, buckets=buckets, **labels)


def observe_batch(name: str, values,
                  buckets: tuple[float, ...] | None = None,
                  **labels: Any) -> None:
    values = list(values)
    for reg in _targets():
        reg.observe_batch(name, values, buckets=buckets, **labels)


# One hook that a span also enters, given its name: it returns a
# context manager to enter, or None. ``ops/backend.py`` installs one
# that opens a ``torch.profiler.record_function`` while torch's profiler
# records, so a profiler trace holds the spans on the clock of its
# kernels and copies. This module imports no torch.
_span_mirror = None


def set_span_mirror(hook):
    """Install ``hook(name) -> context manager | None`` (None: no hook).
    Returns the hook it replaced."""
    global _span_mirror
    previous, _span_mirror = _span_mirror, hook
    return previous


def span_seconds(registry: MetricsRegistry) -> dict[str, float]:
    """Span name -> total seconds of the closed spans of that name in
    ``registry``'s tree (nested spans count in their own name too)."""
    out: dict[str, float] = {}
    with registry._lock:
        stack = list(registry.root.children)
        while stack:
            s = stack.pop()
            stack.extend(s.children)
            if s.duration is not None:
                out[s.name] = out.get(s.name, 0.0) + s.duration
    return {name: round(out[name], 6) for name in sorted(out)}


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span]:
    """Timed scope attached to the innermost bound registry's tree.
    Nested spans become children; exceptions mark the span and
    propagate (telemetry never swallows a build failure). Open/close
    mirror onto the build event bus (no-op unless a sink is bound) and
    into the span mirror's scope (``set_span_mirror``), if it opens one."""
    reg = active_registry()
    parent = _current_span.get()
    if parent is None or parent.registry is not reg:
        parent = reg.root
    s = Span(name, attrs, reg)
    s.parent_id = parent.span_id
    with reg._lock:
        parent.children.append(s)
    _open_spans[id(s)] = s
    token = _current_span.set(s)
    # trace_id rides every span event so a multi-build event stream
    # (a worker's global sinks, the fleet front door's merged log) can
    # be partitioned back into per-trace span trees.
    events.emit("span_start", name=name, span_id=s.span_id,
                parent_id=s.parent_id, trace_id=reg.trace_id,
                **({"attrs": s.attrs} if s.attrs else {}))
    mirror = _span_mirror(name) if _span_mirror is not None else None
    if mirror is not None:
        mirror.__enter__()
    try:
        yield s
    except BaseException as e:
        s.error = f"{type(e).__name__}: {e}"
        raise
    finally:
        if mirror is not None:
            mirror.__exit__(None, None, None)
        s.duration = time.monotonic() - s._t0
        _open_spans.pop(id(s), None)
        _current_span.reset(token)
        events.emit("span_end", name=name, span_id=s.span_id,
                    duration=round(s.duration, 6),
                    trace_id=reg.trace_id,
                    **({"error": s.error} if s.error else {}))


def has_trace_context() -> bool:
    """Whether this context carries an EXPLICIT trace identity — a
    bound per-build registry or an open span. Build-submission paths
    (``WorkerClient.build``) attach a ``traceparent`` only then: the
    process-global registry's id is fine for attributing stray HTTP,
    but adopting it for a build would merge every build a bare
    process submits into one trace (and two concurrent submissions
    into each other's)."""
    return (_build_registry.get() is not None
            or _current_span.get() is not None)


def current_traceparent() -> str:
    """W3C ``traceparent`` header value for the innermost open span of
    the active registry: ``00-<trace-id>-<span-id>-01``. With no span
    open, the registry's root span id is used — every outbound request
    is attributable to a trace even outside a build."""
    reg = active_registry()
    s = _current_span.get()
    if s is None or s.registry is not reg:
        s = reg.root
    return f"00-{reg.trace_id}-{s.span_id}-01"


# -- renderers -------------------------------------------------------------


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_value(value: float) -> str:
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _fmt_labels(key: _LabelKey, extra: tuple[tuple[str, str], ...] = ()
                ) -> str:
    pairs = key + extra
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    """Prometheus text exposition (format 0.0.4) of a registry —
    default: the process-global one (what ``GET /metrics`` serves)."""
    reg = registry if registry is not None else _global
    lines: list[str] = []
    with reg._lock:
        for name in sorted(reg._counters):
            lines.append(f"# TYPE {name} counter")
            for key, value in sorted(reg._counters[name].items()):
                lines.append(f"{name}{_fmt_labels(key)} "
                             f"{_fmt_value(value)}")
        for name in sorted(reg._gauges):
            lines.append(f"# TYPE {name} gauge")
            for key, value in sorted(reg._gauges[name].items()):
                lines.append(f"{name}{_fmt_labels(key)} "
                             f"{_fmt_value(value)}")
        for name in sorted(reg._hists):
            lines.append(f"# TYPE {name} histogram")
            for key, h in sorted(reg._hists[name].items()):
                cumulative = 0
                for le, n in zip(h.buckets, h.bucket_counts):
                    cumulative += n
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(key, (('le', _fmt_value(le)),))} "
                        f"{cumulative}")
                lines.append(
                    f"{name}_bucket{_fmt_labels(key, (('le', '+Inf'),))}"
                    f" {h.count}")
                lines.append(f"{name}_sum{_fmt_labels(key)} "
                             f"{_fmt_value(h.sum)}")
                lines.append(f"{name}_count{_fmt_labels(key)} {h.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def relabel_prometheus(text: str, **labels: str) -> str:
    """Inject labels into every sample line of a Prometheus text
    exposition — how the fleet front door re-exports each worker's
    scrape under a ``worker="wN"`` label so one Prometheus target sees
    the whole fleet. Comment/TYPE lines pass through unchanged; sample
    lines gain the labels FIRST (`name{worker="w0",...} value`), both
    the brace-less and labeled forms. Injected labels are
    operator-controlled (worker ids), so no escaping beyond the
    standard one is needed."""
    if not labels:
        return text
    inject = ",".join(f'{k}="{_escape(str(v))}"'
                      for k, v in sorted(labels.items()))
    out: list[str] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        name, sep, rest = line.partition("{")
        if sep:
            out.append(f"{name}{{{inject},{rest}")
        else:
            name, _, value = line.partition(" ")
            out.append(f"{name}{{{inject}}} {value}")
    return "\n".join(out) + ("\n" if out else "")


def merge_prometheus(parts: list[str]) -> str:
    """Merge several Prometheus text expositions into ONE valid one:
    all samples of a metric family end up in a single group under a
    single ``# TYPE`` line (the format forbids split groups — naive
    concatenation of N scrapes is exactly that). Histogram samples
    (``_bucket``/``_sum``/``_count``) fold into their declared family.
    First TYPE declaration wins; family order is first-seen."""
    order: list[str] = []
    type_line: dict[str, str] = {}
    samples: dict[str, list[str]] = {}
    histograms: set[str] = set()
    # Pass 1: every declared histogram family (so pass 2 can fold
    # suffixed samples even when they appear before/without their own
    # part's TYPE line).
    for text in parts:
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                fields = line.split()
                if len(fields) >= 4 and fields[3] == "histogram":
                    histograms.add(fields[2])

    def family_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) \
                    and name[:-len(suffix)] in histograms:
                return name[:-len(suffix)]
        return name

    for text in parts:
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("# TYPE "):
                fields = line.split()
                if len(fields) >= 3:
                    type_line.setdefault(fields[2], line)
                continue
            if line.startswith("#"):
                continue
            name = line.partition("{")[0].partition(" ")[0]
            family = family_of(name)
            if family not in samples:
                samples[family] = []
                order.append(family)
            samples[family].append(line)
    out: list[str] = []
    for family in order:
        if family in type_line:
            out.append(type_line[family])
        out.extend(samples[family])
    return "\n".join(out) + ("\n" if out else "")


def summary(registry: MetricsRegistry | None = None) -> dict[str, Any]:
    """Flat key/value digest of one build's registry — the fields the
    final ``info("build telemetry", ...)`` line carries."""
    reg = registry if registry is not None else active_registry()
    out: dict[str, Any] = {}
    with reg._lock:
        top = reg.root.children[0] if reg.root.children else None
    duration = top.duration if top is not None else None
    if duration is not None:
        out["duration_seconds"] = round(duration, 3)
    out["cache_hits"] = int(reg.counter_total(
        "makisu_cache_pull_total", result="hit"))
    out["cache_misses"] = int(reg.counter_total(
        "makisu_cache_pull_total", result="miss"))
    out["layers_committed"] = int(reg.counter_total(
        "makisu_layer_commits_total"))
    hashed = reg.counter_by_label("makisu_bytes_hashed_total", "backend")
    for backend, nbytes in sorted(hashed.items()):
        out[f"hashed_bytes_{backend}"] = int(nbytes)
    total_hashed = sum(hashed.values())
    out["hashed_bytes"] = int(total_hashed)
    if duration:
        out["hashed_bytes_per_sec"] = int(total_hashed / duration)
    out["registry_pull_bytes"] = int(reg.counter_total(
        "makisu_registry_bytes_total", direction="pull"))
    out["registry_push_bytes"] = int(reg.counter_total(
        "makisu_registry_bytes_total", direction="push"))
    return out


def write_report(path: str,
                 registry: MetricsRegistry | None = None,
                 **extra: Any) -> None:
    """Write a build's JSON telemetry report (the ``--metrics-out``
    payload): span tree + counters, plus any caller extras (exit code,
    argv). Atomic: tmp file + ``os.replace``, so a build killed
    mid-write never leaves a torn half-JSON report behind."""
    reg = registry if registry is not None else active_registry()
    payload = reg.report()
    payload.update(extra)
    write_json_atomic(path, payload)


def write_json_atomic(path: str, payload: Any) -> None:
    """Atomically serialize ``payload`` as JSON to ``path``. The tmp
    name carries the pid so concurrent builds writing into one
    directory can't cross-clobber each other's staging files.
    ``default=str`` for the same reason the event sinks use it: a
    non-JSON-native span attr must degrade to its repr, not fail the
    invocation after the build itself succeeded."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=False,
                      default=str)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
