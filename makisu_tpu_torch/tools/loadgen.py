"""``loadgen``: synthetic concurrent-build load harness.

Copy of ``makisu_tpu/tools/loadgen.py``, with this package's workers and
front door. The workers it spawns in-process run their builds on
``device`` (``run(args, device=None)``: None is the card; the tests pass
``"cpu"`` for the plain versions), and ``--hasher`` takes ``gpu`` (the
default) or ``cpu``. Nothing here imports torch: the builds do, in the
workers, where they touch the card.

A build farm's scheduler needs numbers:
what queue wait, per-tenant latency, and hash-batch occupancy look
like when N builds hit one worker at once. This harness produces them
against a REAL worker — either a live one (``--socket``) or an
in-process one it spawns for the run — with M generated contexts,
configurable edit churn between rebuilds, and a tenant mix.

Shape of a run:

- ``--contexts K`` template trees are generated (``--files`` files of
  ``--file-kb`` KiB each); each of the ``--concurrency N`` lanes
  copies one template into a private context + storage, so repeated
  builds on a lane hit a warm cache while lanes stay fully parallel.
- Lanes submit builds round-robin until ``--builds M`` complete; each
  rebuild first edits ``--edit-churn`` of the lane's files (append —
  the incremental-rebuild workload). Lane i carries tenant
  ``tenants[i % len]`` via the ``X-Makisu-Tenant`` header.
- A sampler thread polls ``/healthz`` + ``/builds`` through the run:
  the cache hit-rate trajectory, queue depth, and the in-flight peak
  all land in the report.

The structured report (``--report FILE``, schema
``makisu-tpu.loadgen.v1``) carries p50/p99 build latency, the
queue-wait vs execution split, per-tenant latency digests and the
fairness ratio (max tenant p99 ÷ min tenant p99), HashService batch
occupancy scraped from ``/metrics``, and the trajectory. Exit code is
nonzero when any build failed.

``--fleet`` switches to the fleet topology (the front door's
acceptance harness): ``--workers N`` in-process workers — each with
its own storage (a machine's local disk) and resident-session manager
— behind the front-door scheduler, sharing one cache-KV plane
(``fleet/kv.py``). The run first takes a single-worker BASELINE at
equal load (fresh contexts/storage/KV, so nothing warms the fleet
phase), then drives R rounds of the same K contexts through the
scheduler with a per-round barrier:

- round 0 cold, round 1 edited+warm (affinity routes back to each
  context's session holder);
- between rounds 1 and 2, the worker holding context 0 is DRAINED
  (alive, routing off) and a second worker is KILLED outright;
- round 2 rebuilds unchanged content: the drained worker's contexts
  relocate and peer-fetch their chunks worker-to-worker
  (``makisu_fleet_peer_chunk_hits_total``), the killed worker's
  contexts complete via failover, and every relocated build's layer
  digests must equal its round-1 digests byte for byte.

The fleet report section carries the per-worker build distribution,
affinity hit-rate (overall, and over builds whose session holder was
still eligible), verdict tallies, quota enforcement counts, peer
chunk-exchange counters, digest-identity verdicts, and the
p99-vs-single-worker delta. Exit code is nonzero on any failed build
or digest divergence.
"""

from __future__ import annotations

import http.client
import json
import os
import re
import shutil
import tempfile
import threading
import time

from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import metrics
from makisu_tpu_torch.utils import profiler

LOADGEN_SCHEMA = "makisu-tpu.loadgen.v1"

_OCCUPANCY_RE = re.compile(
    r'^makisu_hash_batch_occupancy_(sum|count)\{[^}]*\}\s+(\S+)$',
    re.MULTILINE)


def _make_template(root: str, index: int, files: int,
                   file_kb: int) -> None:
    """One template context: a src/ tree + Dockerfile. Content is
    seeded per (template, file) so distinct templates chunk-dedup
    against each other realistically (shared boilerplate, distinct
    payload)."""
    src = os.path.join(root, "src")
    # exist_ok + overwrite throughout: re-running with the same
    # --work-dir regenerates templates in place instead of crashing
    # on the previous run's trees.
    os.makedirs(src, exist_ok=True)
    for i in range(files):
        body = [f"# template {index} module {i}\n"]
        line = f"payload_{index}_{i} = {i}\n"
        while sum(len(s) for s in body) < file_kb * 1024:
            body.append(line * 16)
        with open(os.path.join(src, f"mod{i}.py"), "w") as f:
            f.write("".join(body))
    # A stable base/ layer edits never touch: warm rebuilds HIT its
    # cache node while the churned src/ node misses — so the hit-rate
    # trajectory and the miss attribution both have signal.
    base = os.path.join(root, "base")
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "vendor.txt"), "w") as f:
        f.write(f"# template {index} vendored base\n" * 64)
    with open(os.path.join(root, "Dockerfile"), "w") as f:
        f.write("FROM scratch\nCOPY base/ /base/\nCOPY src/ /src/\n")


def _edit_files(ctx: str, churn: float, stamp: str) -> int:
    """Append-edit ``churn`` of the context's files (at least one when
    churn > 0) — the between-builds developer edit loadgen models."""
    src = os.path.join(ctx, "src")
    names = sorted(os.listdir(src))
    if not names or churn <= 0:
        return 0
    n_edit = max(1, int(len(names) * churn))
    for name in names[:n_edit]:
        with open(os.path.join(src, name), "a") as f:
            f.write(f"# edited {stamp}\n")
    return n_edit


def _occupancy_from_metrics(text: str) -> dict | None:
    """Average lane occupancy (lanes filled ÷ lane capacity) from the
    worker's Prometheus text — the fleet-batching signal. ``None``
    when the hash service dispatched no batches this run (e.g. the
    native CPU route bypassed it)."""
    total = count = 0.0
    for kind, value in _OCCUPANCY_RE.findall(text):
        try:
            v = float(value)
        except ValueError:
            continue
        if kind == "sum":
            total += v
        else:
            count += v
    if not count:
        return None
    return {"batches": int(count),
            "mean_occupancy": round(total / count, 4)}


class _Sampler(threading.Thread):
    """Polls /healthz + /builds through the run: the cache hit-rate
    trajectory and the in-flight/queue peaks."""

    def __init__(self, client, interval: float) -> None:
        super().__init__(daemon=True, name="loadgen-sampler")
        self.client = client
        self.interval = interval
        self.samples: list[dict] = []
        self.peak_inflight = 0
        self.peak_queue_depth = 0
        self.saw_running_build = False
        self._halt = threading.Event()

    def run(self) -> None:
        t0 = time.monotonic()
        while not self._halt.is_set():
            try:
                health = self.client.healthz()
                builds = self.client.builds()
            except (OSError, RuntimeError, ValueError):
                self._halt.wait(self.interval)
                continue
            cache = health.get("cache", {})
            hits = cache.get("hits", 0)
            misses = cache.get("misses", 0)
            inflight = builds.inflight
            self.peak_inflight = max(self.peak_inflight, len(inflight))
            self.peak_queue_depth = max(self.peak_queue_depth,
                                        builds.queue_depth)
            if any(b.state == "running" for b in inflight):
                self.saw_running_build = True
            self.samples.append({
                "t": round(time.monotonic() - t0, 3),
                "active_builds": health.active_builds,
                "queue_depth": builds.queue_depth,
                "cache_hits": hits,
                "cache_misses": misses,
                "cache_hit_ratio": round(hits / (hits + misses), 4)
                if hits + misses else 0.0,
                "chunk_dedup_ratio": cache.get("chunk_dedup_ratio",
                                               0.0),
            })
            self._halt.wait(self.interval)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5)


def run(args, device=None) -> int:
    """Run the mode ``args`` names; every worker it spawns builds on
    ``device`` (None: the card)."""
    if getattr(args, "evict_soak", False):
        return _run_evict_soak(args, device)
    if getattr(args, "prewarm_smoke", False):
        return _run_prewarm_smoke(args, device)
    if getattr(args, "slo_smoke", False):
        return _run_slo_smoke(args, device)
    if getattr(args, "fleet", False):
        return _run_fleet(args, device)
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer

    concurrency = max(1, args.concurrency)
    total_builds = args.builds if args.builds > 0 else 2 * concurrency
    n_contexts = max(1, min(args.contexts or concurrency,
                            concurrency))
    tenants = [t for t in (args.tenants or "").split(",") if t] \
        or ["default"]

    work_dir = args.work_dir or tempfile.mkdtemp(
        prefix="makisu-loadgen-")
    os.makedirs(work_dir, exist_ok=True)
    cleanup_work = not args.work_dir

    server = None
    sampler = None
    metrics_text = ""
    final_health: dict = {}
    profile_doc: dict | None = None
    wall = 0.0
    socket_path = args.socket
    templates: list[str] = []

    results: list[dict] = []
    results_mu = threading.Lock()
    next_seq = [0]

    def lane(i: int) -> None:
        client = WorkerClient(socket_path)
        tenant = tenants[i % len(tenants)]
        ctx = os.path.join(work_dir, f"lane{i}", "ctx")
        os.makedirs(os.path.dirname(ctx), exist_ok=True)
        shutil.copytree(templates[i % n_contexts], ctx,
                        dirs_exist_ok=True)
        storage = os.path.join(work_dir, f"lane{i}", "storage")
        root = os.path.join(work_dir, f"lane{i}", "root")
        os.makedirs(root, exist_ok=True)
        lane_build = 0
        while True:
            with results_mu:
                seq = next_seq[0]
                if seq >= total_builds:
                    return
                next_seq[0] += 1
            if lane_build > 0:
                _edit_files(ctx, args.edit_churn, f"b{seq}")
            argv = ["--log-level", "error",
                    "build", ctx, "-t", f"loadgen/lane{i}:b{seq}",
                    "--storage", storage, "--root", root,
                    "--hasher", args.hasher]
            if args.history_out:
                argv = ["--history-out", args.history_out] + argv
            t0 = time.monotonic()
            # Each synthetic build gets its OWN trace registry, so the
            # worker-side build adopts a distinct trace id per
            # submission (stitching without collapsing concurrent
            # lanes into one trace).
            lane_reg = metrics.MetricsRegistry()
            reg_token = metrics.set_build_registry(lane_reg)
            try:
                code = client.build(argv, tenant=tenant)
            except (OSError, RuntimeError) as e:
                code = -1
                log.error("loadgen lane %d build %d failed to "
                          "submit: %s", i, seq, e)
            finally:
                metrics.reset_build_registry(reg_token)
            elapsed = time.monotonic() - t0
            terminal = client.last_build or {}
            queue_wait = float(terminal.get("queue_wait_seconds",
                                            0.0))
            with results_mu:
                results.append({
                    "seq": seq,
                    "lane": i,
                    "tenant": tenant,
                    "exit_code": code,
                    "latency_seconds": round(elapsed, 3),
                    "queue_wait_seconds": round(queue_wait, 3),
                    "exec_seconds": round(
                        max(elapsed - queue_wait, 0.0), 3),
                    "warm": lane_build > 0,
                })
            lane_build += 1

    # Everything past this point — including worker spawn and template
    # generation — runs under one finally, so an error (or the worker
    # never answering /ready) can't leak the spawned server, its
    # socket, or a mkdtemp work directory.
    try:
        if not socket_path:
            socket_path = os.path.join(work_dir,
                                       "loadgen-worker.sock")
            server = WorkerServer(
                socket_path,
                max_concurrent_builds=args.max_concurrent_builds,
                device=device)
            server.serve_background()
            log.info("loadgen spawned in-process worker on %s "
                     "(max_concurrent_builds=%d)", socket_path,
                     server.max_concurrent_builds)

        for k in range(n_contexts):
            template = os.path.join(work_dir, f"template{k}")
            _make_template(template, k, args.files, args.file_kb)
            templates.append(template)

        client = WorkerClient(socket_path)
        deadline = time.monotonic() + args.ready_timeout
        while not client.ready():
            if time.monotonic() >= deadline:
                log.error("worker on %s never became ready",
                          socket_path)
                return 1
            time.sleep(0.1)

        sampler = _Sampler(client, args.poll_interval)
        sampler.start()
        t_run = time.monotonic()
        lanes = [threading.Thread(target=lane, args=(i,),
                                  name=f"loadgen-lane-{i}")
                 for i in range(concurrency)]
        for t in lanes:
            t.start()
        for t in lanes:
            t.join()
        wall = time.monotonic() - t_run
        try:
            metrics_text = client.metrics()
            final_health = dict(client.healthz())
        except (OSError, RuntimeError):
            pass
        # Snapshot the continuous profile BEFORE teardown: when the
        # spawned worker armed the process sampler, server_close()
        # stops it (the builds ran on its handler threads in this
        # process, so the sampler saw them).
        prof = profiler.process_profiler()
        if prof is not None and prof.samples_total:
            profile_doc = prof.snapshot(command="loadgen")
    finally:
        if sampler is not None:
            sampler.stop()
        if server is not None:
            server.shutdown()
            server.server_close()
        if cleanup_work:
            shutil.rmtree(work_dir, ignore_errors=True)

    report = _build_report(args, results, sampler, metrics_text,
                           final_health, wall, tenants, profile_doc)
    if args.report:
        metrics.write_json_atomic(args.report, report)
        log.info("loadgen report written to %s", args.report)
    print(render_report(report), end="")
    return 0 if report["failures"] == 0 and results else 1


def _profile_digest(doc: dict | None) -> dict | None:
    """Compact continuous-profiling section for the loadgen report:
    sampler vitals, phase shares, and the top self-time frames. The
    full artifact (folded stacks + speedscope) goes to --profile-out;
    the report carries just enough to spot where the run burned its
    wall clock."""
    if not doc or not doc.get("samples"):
        return None
    total = doc["samples"] or 1
    phases = doc.get("phases") or {}
    frames = profiler.self_time_by_frame(doc)
    top = sorted(sorted(frames), key=lambda f: -frames[f])[:5]
    return {
        "samples": doc["samples"],
        "hz": doc.get("hz", 0.0),
        "dropped": doc.get("dropped", 0),
        "overhead_fraction": doc.get("overhead_fraction", 0.0),
        "phase_shares": {p: round(n / total, 4)
                         for p, n in sorted(phases.items())},
        "top_frames": [{"frame": f,
                        "share": round(frames[f] / total, 4)}
                       for f in top],
    }


def _build_report(args, results, sampler, metrics_text, final_health,
                  wall, tenants, profile_doc=None) -> dict:
    ok = [r for r in results if r["exit_code"] == 0]
    latencies = [r["latency_seconds"] for r in ok]
    waits = [r["queue_wait_seconds"] for r in ok]
    execs = [r["exec_seconds"] for r in ok]
    per_tenant = {}
    for tenant in tenants:
        mine = [r["latency_seconds"] for r in ok
                if r["tenant"] == tenant]
        per_tenant[tenant] = metrics.percentile_stats(mine)
    p99s = [stats["p99"] for stats in per_tenant.values()
            if stats["count"]]
    fairness = (round(max(p99s) / min(p99s), 3)
                if len(p99s) > 1 and min(p99s) > 0 else 1.0)
    warm = [r["latency_seconds"] for r in ok if r["warm"]]
    cold = [r["latency_seconds"] for r in ok if not r["warm"]]
    total_wait = sum(waits)
    total_latency = sum(latencies)
    return {
        "schema": LOADGEN_SCHEMA,
        "config": {
            "concurrency": args.concurrency,
            "builds": len(results),
            "contexts": args.contexts or args.concurrency,
            "files": args.files,
            "file_kb": args.file_kb,
            "edit_churn": args.edit_churn,
            "tenants": tenants,
            "hasher": args.hasher,
            "max_concurrent_builds": args.max_concurrent_builds,
        },
        "wall_seconds": round(wall, 3),
        "builds": len(results),
        "failures": sum(1 for r in results if r["exit_code"] != 0),
        "throughput_builds_per_s": round(len(results) / wall, 3)
        if wall else 0.0,
        "latency_seconds": metrics.percentile_stats(latencies),
        "queue_wait_seconds": metrics.percentile_stats(waits),
        "exec_seconds": metrics.percentile_stats(execs),
        # What fraction of total build latency was spent waiting for
        # admission — the saturation signal.
        "queue_wait_share": round(total_wait / total_latency, 4)
        if total_latency else 0.0,
        "cold_latency_seconds": metrics.percentile_stats(cold),
        "warm_latency_seconds": metrics.percentile_stats(warm),
        "tenant_latency_seconds": per_tenant,
        "tenant_fairness_p99_ratio": fairness,
        "hash_batch_occupancy":
            _occupancy_from_metrics(metrics_text),
        "peak_inflight": sampler.peak_inflight,
        "peak_queue_depth": sampler.peak_queue_depth,
        "saw_running_build": sampler.saw_running_build,
        "cache_trajectory": sampler.samples,
        "worker_health": final_health,
        "profile": _profile_digest(profile_doc),
        "results": results,
    }


def render_report(report: dict) -> str:
    """Human digest of a loadgen report (the JSON carries the rest)."""
    lat = report["latency_seconds"]
    wait = report["queue_wait_seconds"]
    execs = report["exec_seconds"]
    lines = [
        f"loadgen: {report['builds']} builds "
        f"({report['failures']} failed) in "
        f"{report['wall_seconds']:.1f}s — "
        f"{report['throughput_builds_per_s']:.2f} builds/s",
        f"  latency    p50 {lat.get('p50', 0.0):7.3f}s  "
        f"p99 {lat.get('p99', 0.0):7.3f}s",
        f"  queue wait p50 {wait.get('p50', 0.0):7.3f}s  "
        f"p99 {wait.get('p99', 0.0):7.3f}s  "
        f"(share {100.0 * report['queue_wait_share']:.1f}%)",
        f"  execution  p50 {execs.get('p50', 0.0):7.3f}s  "
        f"p99 {execs.get('p99', 0.0):7.3f}s",
    ]
    warm = report["warm_latency_seconds"]
    cold = report["cold_latency_seconds"]
    if warm.get("count") and cold.get("count"):
        lines.append(
            f"  cold p50 {cold['p50']:.3f}s → warm p50 "
            f"{warm['p50']:.3f}s")
    for tenant, stats in sorted(
            report["tenant_latency_seconds"].items()):
        if stats.get("count"):
            lines.append(
                f"  tenant {tenant:<12s} p50 {stats['p50']:7.3f}s  "
                f"p99 {stats['p99']:7.3f}s  ({stats['count']} builds)")
    lines.append(f"  fairness (max/min tenant p99): "
                 f"{report['tenant_fairness_p99_ratio']:.2f}")
    occ = report["hash_batch_occupancy"]
    if occ:
        lines.append(f"  hash batch occupancy: "
                     f"{100.0 * occ['mean_occupancy']:.1f}% over "
                     f"{occ['batches']} batches")
    traj = report["cache_trajectory"]
    if traj:
        lines.append(
            f"  cache hit-rate trajectory: "
            f"{100.0 * traj[0]['cache_hit_ratio']:.0f}% → "
            f"{100.0 * traj[-1]['cache_hit_ratio']:.0f}% over "
            f"{len(traj)} samples")
    lines.append(f"  peak in-flight {report['peak_inflight']}, "
                 f"peak queue depth {report['peak_queue_depth']}")
    prof = report.get("profile")
    if prof:
        shares = "  ".join(
            f"{p} {100.0 * s:.0f}%"
            for p, s in sorted(prof["phase_shares"].items(),
                               key=lambda kv: -kv[1]) if s >= 0.005)
        lines.append(
            f"  profile: {prof['samples']} samples @ "
            f"{prof['hz']:g} Hz  (overhead "
            f"{100.0 * prof['overhead_fraction']:.2f}%)  {shares}")
        if prof["top_frames"]:
            hot = prof["top_frames"][0]
            lines.append(
                f"    hottest frame {hot['frame']} "
                f"({100.0 * hot['share']:.1f}% self time)")
    fleet = report.get("fleet")
    if fleet:
        lines.append("  fleet:")
        lines.append(
            "    distribution " + "  ".join(
                f"{wid}:{n}" for wid, n in sorted(
                    fleet["distribution"].items())))
        lines.append(
            f"    affinity hit-rate "
            f"{100.0 * fleet['affinity_hit_rate']:.0f}% "
            f"(eligible "
            f"{100.0 * fleet['affinity_hit_rate_eligible']:.0f}%)   "
            f"verdicts " + " ".join(
                f"{v}:{n}" for v, n in sorted(
                    fleet["route_totals"].items())))
        lines.append(
            f"    drained {fleet['disruption'].get('drained') or '-'}"
            f"  killed {fleet['disruption'].get('killed') or '-'}  "
            f"relocated {fleet['relocated_builds']} "
            f"(+{fleet['failover_builds']} mid-route failovers)  "
            f"digests "
            f"{'identical' if fleet['digest_identity'] else 'DIVERGED'}")
        lines.append(
            f"    peer chunks {fleet['peer_chunk_hits']} "
            f"({fleet['peer_chunk_bytes']} B) served worker-to-worker "
            f"via {fleet.get('peer_pack_requests', 0)} ranged pack "
            f"read(s) ({fleet.get('peer_pack_bytes', 0)} B)")
        lines.append(
            f"    p99 {fleet['p99_seconds']:.3f}s vs single-worker "
            f"{fleet['baseline_p99_seconds']:.3f}s "
            f"(delta {fleet['p99_delta_seconds']:+.3f}s)")
    return "\n".join(lines) + "\n"


# -- fleet mode --------------------------------------------------------------


def _layer_digests(storage: str, tag: str) -> list[str]:
    """Layer digests of a built tag, read from the worker's storage —
    the byte-identity oracle the fleet phases assert against."""
    from makisu_tpu_torch.docker.image import ImageName
    from makisu_tpu_torch.storage import ImageStore
    with ImageStore(storage) as store:
        manifest = store.manifests.load(ImageName.parse(tag))
        return [layer.digest.hex() for layer in manifest.layers]


def _drive_rounds(socket_path: str, contexts: list[str],
                  roots: list[str], tenants: list[str],
                  rounds: int, args, kv_addr: str,
                  storage_for: "dict | str",
                  results: list[dict], phase: str,
                  on_round_end=None) -> None:
    """K per-context threads × R rounds with a barrier between rounds
    (so disruption hooks fire at a quiet point, the way a maintenance
    window would). ``storage_for`` maps worker id -> storage (fleet:
    the front door rewrites --storage; digests are read back from the
    serving worker's disk) or is the one storage dir (baseline).
    Edits land before round 1 only: rounds >= 2 rebuild UNCHANGED
    content, making cross-worker digest identity assertable."""
    import threading as threading_mod

    from makisu_tpu_torch.worker import WorkerClient

    n = len(contexts)
    barrier = threading_mod.Barrier(
        n, action=(lambda: on_round_end(round_cell[0]))
        if on_round_end else None)
    round_cell = [0]
    results_mu = threading_mod.Lock()

    def drive(j: int) -> None:
        client = WorkerClient(socket_path)
        tenant = tenants[j % len(tenants)]
        for r in range(rounds):
            if r == 1:
                _edit_files(contexts[j], args.edit_churn,
                            f"{phase}-r{r}")
            tag = f"loadgen/{phase}-ctx{j}:r{r}"
            argv = ["--log-level", "error",
                    "build", contexts[j], "-t", tag,
                    "--hasher", args.hasher, "--root", roots[j],
                    "--http-cache-addr", kv_addr]
            if isinstance(storage_for, str):
                argv += ["--storage", storage_for]
            t0 = time.monotonic()
            # Per-build trace registry: each round's build stitches
            # under its own trace id through the front door.
            drive_reg = metrics.MetricsRegistry()
            reg_token = metrics.set_build_registry(drive_reg)
            try:
                code = client.build(argv, tenant=tenant)
            except (OSError, RuntimeError,
                    http.client.HTTPException) as e:
                # A dropped stream (front-door handler death) raises
                # IncompleteRead — an HTTPException, not an OSError.
                # The lane must record the failure and reach the
                # barrier, not die and stall every sibling on the
                # barrier timeout.
                code = -1
                log.error("fleet loadgen ctx %d round %d failed to "
                          "submit: %s", j, r, e)
            finally:
                metrics.reset_build_registry(reg_token)
            elapsed = time.monotonic() - t0
            terminal = client.last_build or {}
            worker = str(terminal.get("worker", ""))
            if isinstance(storage_for, str):
                storage = storage_for
            else:
                storage = storage_for.get(worker, "")
            digests: list[str] = []
            if code == 0 and storage:
                try:
                    digests = _layer_digests(storage, tag)
                except (OSError, KeyError) as e:
                    log.warning("could not read digests for %s: %s",
                                tag, e)
            with results_mu:
                results.append({
                    "phase": phase,
                    "context": j,
                    "round": r,
                    "tenant": tenant,
                    "exit_code": code,
                    "latency_seconds": round(elapsed, 3),
                    "queue_wait_seconds": round(float(
                        terminal.get("queue_wait_seconds", 0.0)), 3),
                    "quota_wait_seconds": round(float(
                        terminal.get("quota_wait_seconds", 0.0)), 3),
                    "worker": worker,
                    "verdict": str(terminal.get("fleet_verdict", "")),
                    "attempts": int(
                        terminal.get("fleet_attempts", 1) or 1),
                    "digests": digests,
                    "warm": r > 0,
                })
            try:
                barrier.wait(timeout=600)
            except threading_mod.BrokenBarrierError:
                return  # a sibling died; don't hang the run
            if j == 0:
                round_cell[0] = r + 1

    threads = [threading_mod.Thread(target=drive, args=(j,),
                                    name=f"fleet-ctx-{j}")
               for j in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _run_fleet(args, device=None) -> int:
    """Fleet topology: baseline pass, then N workers behind the
    scheduler with a drain + kill disruption between warm rounds."""
    from makisu_tpu_torch.fleet import FleetServer, WorkerSpec
    from makisu_tpu_torch.fleet import peers as fleet_peers
    from makisu_tpu_torch.fleet.kv import SharedKVServer
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer
    from makisu_tpu_torch.worker.client import _UnixHTTPConnection

    n_workers = max(2, args.workers)
    n_ctx = max(2, args.contexts or n_workers)
    rounds = max(3, args.rounds or 3)
    tenants = [t for t in (args.tenants or "").split(",") if t] \
        or ["default"]
    work_dir = args.work_dir or tempfile.mkdtemp(
        prefix="makisu-fleet-loadgen-")
    os.makedirs(work_dir, exist_ok=True)
    cleanup_work = not args.work_dir

    servers: dict[str, object] = {}
    specs: list[WorkerSpec] = []
    fleet_server = None
    fleet_kv = None
    baseline_kv = None
    baseline_server = None
    results: list[dict] = []
    baseline_results: list[dict] = []
    disruption = {"drained": "", "killed": ""}
    sampler = None
    fleet_stats: dict = {}
    fleet_metrics_text = ""
    wall = 0.0

    def spawn_worker(wid: str):
        sock = os.path.join(work_dir, f"{wid}.sock")
        server = WorkerServer(
            sock, max_concurrent_builds=args.max_concurrent_builds,
            device=device)
        server.serve_background()
        return server, os.path.join(work_dir, f"{wid}-storage")

    def wait_ready(socket_path: str) -> bool:
        client = WorkerClient(socket_path)
        deadline = time.monotonic() + args.ready_timeout
        while not client.ready():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)
        return True

    def make_contexts(prefix: str):
        ctxs, roots = [], []
        for j in range(n_ctx):
            ctx = os.path.join(work_dir, f"{prefix}-ctx{j}")
            _make_template(ctx, j, args.files, args.file_kb)
            root = os.path.join(work_dir, f"{prefix}-root{j}")
            os.makedirs(root, exist_ok=True)
            ctxs.append(ctx)
            roots.append(root)
        return ctxs, roots

    try:
        # ---- single-worker baseline at equal load (fresh contexts,
        # storage, and KV: nothing here may warm the fleet phase).
        baseline_kv = SharedKVServer()
        baseline_addr = baseline_kv.start()
        baseline_server, baseline_storage = spawn_worker("baseline")
        if not wait_ready(baseline_server.socket_path):
            log.error("baseline worker never became ready")
            return 1
        base_ctxs, base_roots = make_contexts("base")
        t0 = time.monotonic()
        _drive_rounds(baseline_server.socket_path, base_ctxs,
                      base_roots, tenants, rounds, args,
                      baseline_addr, baseline_storage,
                      baseline_results, "baseline")
        baseline_wall = time.monotonic() - t0
        baseline_server.shutdown()
        baseline_server.server_close()
        baseline_server = None
        baseline_kv.stop()
        baseline_kv = None

        # ---- the fleet: N workers + shared KV + front door.
        fleet_kv = SharedKVServer()
        kv_addr = fleet_kv.start()
        for i in range(n_workers):
            wid = f"w{i}"
            server, storage = spawn_worker(wid)
            servers[wid] = server
            specs.append(WorkerSpec(
                wid, server.socket_path, storage))
        for spec in specs:
            if not wait_ready(spec.socket_path):
                log.error("fleet worker %s never became ready",
                          spec.id)
                return 1
        fleet_server = FleetServer(
            os.path.join(work_dir, "fleet.sock"), specs,
            poll_interval=min(args.poll_interval, 0.5),
            tenant_quota=args.tenant_quota)
        fleet_server.serve_background()
        if not wait_ready(fleet_server.socket_path):
            log.error("fleet front door never became ready")
            return 1
        front = WorkerClient(fleet_server.socket_path)
        sampler = _Sampler(front, args.poll_interval)
        sampler.start()
        ctxs, roots = make_contexts("fleet")
        storage_for = {spec.id: spec.storage for spec in specs}

        def holder_of(context_index: int) -> str:
            for row in reversed(results):
                if row["context"] == context_index \
                        and row["exit_code"] == 0:
                    return row["worker"]
            return ""

        def disrupt(finished_round: int) -> None:
            """Barrier action between rounds: after the warm round,
            drain context 0's session holder (its contexts relocate
            and peer-fetch their chunks from it) and kill a DIFFERENT
            worker outright (its contexts complete via failover)."""
            if finished_round != 1:
                return
            drained = holder_of(0)
            if drained:
                conn = _UnixHTTPConnection(fleet_server.socket_path,
                                           10.0)
                try:
                    conn.request(
                        "POST", "/drain",
                        body=json.dumps({"worker": drained}).encode(),
                        headers={"Content-Type": "application/json"})
                    conn.getresponse().read()
                    disruption["drained"] = drained
                except OSError as e:
                    log.warning("drain failed: %s", e)
                finally:
                    conn.close()
            victims = [wid for wid in servers
                       if wid != drained]
            # Prefer a victim that actually holds contexts, so the
            # kill forces real failover work — but never kill the
            # LAST routable worker (a 2-worker fleet drains only;
            # the kill phase needs >= 3).
            holders = {holder_of(j) for j in range(n_ctx)}
            preferred = [w for w in victims if w in holders]
            victim = (preferred or victims)[0] \
                if len(victims) >= 2 else ""
            if victim:
                server = servers.pop(victim)
                server.shutdown()
                server.server_close()
                try:
                    os.unlink(server.socket_path)
                except OSError:
                    pass
                disruption["killed"] = victim
                log.info("fleet loadgen: drained %s, killed %s",
                         drained or "<none>", victim)

        t0 = time.monotonic()
        _drive_rounds(fleet_server.socket_path, ctxs, roots, tenants,
                      rounds, args, kv_addr, storage_for, results,
                      "fleet", on_round_end=disrupt)
        wall = time.monotonic() - t0
        fleet_stats = json.loads(_front_get(
            fleet_server.socket_path, "/fleet"))
        # One scrape of the front door's AGGREGATED /metrics covers
        # the whole fleet (each worker's series re-exported under a
        # worker label): occupancy parses from it exactly like the
        # single-worker path, and the distinct worker labels prove
        # the aggregation actually fanned out.
        try:
            fleet_metrics_text = front.metrics()
        except (OSError, RuntimeError):
            fleet_metrics_text = ""
    finally:
        if sampler is not None:
            sampler.stop()
        if fleet_server is not None:
            fleet_server.shutdown()
            fleet_server.server_close()
        for server in servers.values():
            server.shutdown()
            server.server_close()
        for stoppable in (baseline_server,):
            if stoppable is not None:
                stoppable.shutdown()
                stoppable.server_close()
        for kv in (fleet_kv, baseline_kv):
            if kv is not None:
                kv.stop()
        fleet_peers.reset()
        if cleanup_work:
            shutil.rmtree(work_dir, ignore_errors=True)

    report = _build_fleet_report(args, results, baseline_results,
                                 disruption, fleet_stats, sampler,
                                 wall, baseline_wall, tenants,
                                 n_workers, n_ctx, rounds,
                                 metrics.global_registry(),
                                 fleet_metrics_text)
    if args.report:
        metrics.write_json_atomic(args.report, report)
        log.info("fleet loadgen report written to %s", args.report)
    print(render_report(report), end="")
    # The BASELINE phase's failures gate the exit code too: a broken
    # baseline corrupts the p99 comparison the fleet section quotes.
    ok = (report["failures"] == 0 and results
          and report["fleet"]["baseline"]["failures"] == 0
          and baseline_results
          and report["fleet"]["digest_identity"])
    return 0 if ok else 1


# -- SLO fault-injection smoke ----------------------------------------------


def _run_slo_smoke(args, device=None) -> int:
    """The SLO plane's acceptance scenario, end to end on real
    surfaces (no test-only hooks):

    1. A 3-worker fleet runs with fast canary sweeps and evaluation
       ticks, plus a ``--slo-config`` that shrinks the
       ``build_latency_burn`` windows to test time.
    2. One worker is WEDGED by holding all of its admission slots —
       the exact shape of a worker stuck behind a hung build. Its
       canaries refuse instantly (no-wait admission), the burn-rate
       alert must fire within two evaluation intervals, and the
       ``makisu-tpu alerts`` render must name the rule.
    3. Fresh contexts routed through the front door must land on the
       healthy workers only, with ``health_demoted`` verdicts in the
       route-decision ledger — and the healthy workers' canary layer
       digests must be byte-identical.
    4. The held slots are released; the alert must auto-resolve.

    Alert transitions are captured off the event bus into an
    alert-only NDJSON file (``--alert-events-out``) — the CI artifact.
    Exit code is nonzero when any gate fails."""
    from makisu_tpu_torch.fleet import FleetServer, WorkerSpec
    from makisu_tpu_torch.fleet import peers as fleet_peers
    from makisu_tpu_torch.utils import events
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer

    n_workers = max(3, args.workers)
    work_dir = args.work_dir or tempfile.mkdtemp(
        prefix="makisu-slo-smoke-")
    os.makedirs(work_dir, exist_ok=True)
    cleanup_work = not args.work_dir
    events_path = args.alert_events_out or os.path.join(
        work_dir, "alerts.ndjson")

    # Test-time cadence: canary sweeps and evaluation ticks well under
    # a second, a shrunken fast window, and a slow window the run's
    # since-oldest fallback keeps meaningful.
    canary_interval = 0.75
    slo_interval = 0.5
    canary_slow_seconds = 5.0
    fast_window = 3.0
    slo_config = os.path.join(work_dir, "slo-smoke-rules.json")
    metrics.write_json_atomic(slo_config, {"rules": [
        {"name": "build_latency_burn",
         "fast_window_seconds": fast_window,
         "slow_window_seconds": 60.0},
    ]})
    # Two evaluation intervals, where one interval is a full canary
    # sweep (its per-worker build budget) plus an evaluator tick.
    fire_deadline = 2 * (canary_interval + canary_slow_seconds
                         + slo_interval)

    sink = events.JsonlWriter(events_path, event_types={"alert"})
    events.add_global_sink(sink)
    servers: dict[str, WorkerServer] = {}
    fleet_server = None
    held_slots = 0
    victim = ""
    slo: dict = {"rule": "build_latency_burn"}
    gates: dict[str, bool] = {}

    def front_alerts() -> dict:
        try:
            return json.loads(_front_get(
                fleet_server.socket_path, "/alerts"))
        except (OSError, ValueError):
            return {}

    def burn_active(snap: dict) -> dict | None:
        for a in snap.get("active") or []:
            if a.get("rule") == "build_latency_burn" \
                    and a.get("label") == victim:
                return a
        return None

    def wait_for(predicate, deadline_seconds: float) -> float | None:
        """Poll the predicate; seconds it took, or None on timeout."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_seconds:
            if predicate():
                return time.monotonic() - t0
            time.sleep(0.1)
        return None

    try:
        specs = []
        for i in range(n_workers):
            wid = f"w{i}"
            sock = os.path.join(work_dir, f"{wid}.sock")
            # Bounded admission (2 slots) is the fault surface: the
            # wedge holds every slot, and on healthy workers a canary
            # and one routed build can coexist without a false refusal.
            server = WorkerServer(sock, max_concurrent_builds=2,
                                  device=device)
            server.serve_background()
            servers[wid] = server
            specs.append(WorkerSpec(
                wid, sock, os.path.join(work_dir, f"{wid}-storage")))
        for spec in specs:
            client = WorkerClient(spec.socket_path)
            deadline = time.monotonic() + args.ready_timeout
            while not client.ready():
                if time.monotonic() >= deadline:
                    log.error("slo-smoke worker %s never became "
                              "ready", spec.id)
                    return 1
                time.sleep(0.05)
        fleet_server = FleetServer(
            os.path.join(work_dir, "fleet.sock"), specs,
            poll_interval=0.25,
            slo_config=slo_config,
            slo_interval=slo_interval,
            canary_interval=canary_interval,
            canary_slow_seconds=canary_slow_seconds,
            canary_hasher=args.hasher)
        fleet_server.serve_background()
        front_client = WorkerClient(fleet_server.socket_path)
        deadline = time.monotonic() + args.ready_timeout
        while not front_client.ready():
            if time.monotonic() >= deadline:
                log.error("slo-smoke front door never became ready")
                return 1
            time.sleep(0.05)

        # Healthy baseline: every worker has at least one clean canary
        # (scores at 1.0, reference digests on disk) before the fault.
        baselined = wait_for(
            lambda: len([
                row for row in (front_alerts().get("canary") or {})
                .get("workers", {}).values()
                if row.get("total", 0) >= 1 and row.get("ok")
            ]) >= n_workers, 60.0)
        if baselined is None:
            log.error("slo-smoke: canaries never baselined")
            return 1

        # -- the fault: hold every admission slot on one worker.
        victim = specs[0].id
        t_wedge = time.monotonic()
        for _ in range(2):
            servers[victim]._admission.acquire()
            held_slots += 1
        slo["victim"] = victim

        fired_after = wait_for(
            lambda: burn_active(front_alerts()) is not None,
            fire_deadline)
        gates["fired_within_two_intervals"] = fired_after is not None
        slo["fired_seconds"] = round(
            time.monotonic() - t_wedge, 3) \
            if fired_after is not None else None
        slo["fire_deadline_seconds"] = round(fire_deadline, 3)
        # One bad canary of two already fires the burn rule (0.5 is the
        # threshold, and the exact threshold fires), but the scheduler
        # demotes only at a score at or below the page threshold, which
        # takes a second bad canary. Routing is driven once the victim
        # is demoted, so the routing gates test routing, not the race.
        from makisu_tpu_torch.fleet import slo as slo_mod

        def victim_score() -> float:
            rows = (front_alerts().get("canary") or {}).get("workers", {})
            return float((rows.get(victim) or {}).get("score", 1.0))

        demoted_after = wait_for(
            lambda: victim_score() <= slo_mod.HEALTH_PAGE_THRESHOLD,
            fire_deadline)
        slo["demoted_seconds"] = round(time.monotonic() - t_wedge, 3) \
            if demoted_after is not None else None

        # The CLI surface, through the real subcommand handler.
        import argparse
        import contextlib
        import io

        from makisu_tpu_torch import cli as cli_mod
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_mod.cmd_alerts(argparse.Namespace(
                socket=fleet_server.socket_path, json_out=False))
        cli_render = buf.getvalue()
        gates["cli_render_names_rule"] = \
            "build_latency_burn" in cli_render
        slo["cli_render"] = cli_render

        # -- routing must shift away: fresh contexts (no affinity)
        # driven sequentially so healthy workers never see a canary
        # and two routed builds contend for the same two slots.
        front = WorkerClient(fleet_server.socket_path)
        routed: list[str] = []
        failures = 0
        for j in range(4):
            ctx = os.path.join(work_dir, f"slo-ctx{j}")
            _make_template(ctx, j, files=4, file_kb=2)
            root = os.path.join(work_dir, f"slo-root{j}")
            os.makedirs(root, exist_ok=True)
            reg_token = metrics.set_build_registry(
                metrics.MetricsRegistry())
            try:
                code = front.build(
                    ["--log-level", "error", "build", ctx,
                     "-t", f"slo-smoke/ctx{j}:latest",
                     "--hasher", args.hasher, "--root", root],
                    tenant="default")
            except (OSError, RuntimeError,
                    http.client.HTTPException) as e:
                code = -1
                log.error("slo-smoke routed build %d failed: %s",
                          j, e)
            finally:
                metrics.reset_build_registry(reg_token)
            if code != 0:
                failures += 1
            terminal = front.last_build or {}
            routed.append(str(terminal.get("worker", "")))
        fleet_stats = json.loads(_front_get(
            fleet_server.socket_path, "/fleet"))
        demotions = [d for d in fleet_stats.get(
            "recent_decisions", [])
            if d.get("verdict") == "health_demoted"
            and d.get("worker") == victim]
        gates["builds_succeeded"] = failures == 0
        gates["routing_shifted"] = (victim not in routed
                                    and all(routed))
        gates["health_demoted_recorded"] = (
            int(fleet_stats.get("route_totals", {}).get(
                "health_demoted", 0)) >= 1 and bool(demotions))
        slo["routed_workers"] = routed
        slo["health_demoted_decisions"] = len(demotions)
        slo["route_totals"] = fleet_stats.get("route_totals", {})

        # -- canary digest identity across the HEALTHY workers.
        canary = front_alerts().get("canary") or {}
        healthy_digests = {
            tuple(row.get("digests") or ())
            for wid, row in (canary.get("workers") or {}).items()
            if wid != victim and row.get("ok")}
        gates["digest_identity"] = (
            not canary.get("digest_mismatch")
            and len(healthy_digests) == 1
            and () not in healthy_digests)
        slo["canary"] = {
            wid: {k: row.get(k) for k in
                  ("score", "total", "bad", "ok")}
            for wid, row in (canary.get("workers") or {}).items()}

        # -- clear the fault; the alert must auto-resolve once the
        # fast window drains and the resolve hysteresis clears.
        while held_slots:
            servers[victim]._admission.release()
            held_slots -= 1
        t_release = time.monotonic()
        resolved_after = wait_for(
            lambda: burn_active(front_alerts()) is None,
            fast_window + 30.0)
        gates["resolved_after_release"] = resolved_after is not None
        slo["resolved_seconds"] = round(
            time.monotonic() - t_release, 3) \
            if resolved_after is not None else None
    finally:
        while held_slots:
            servers[victim]._admission.release()
            held_slots -= 1
        if fleet_server is not None:
            fleet_server.shutdown()
            fleet_server.server_close()
        for server in servers.values():
            server.shutdown()
            server.server_close()
        fleet_peers.reset()
        events.remove_global_sink(sink)
        sink.close()

    alert_events = events.read_jsonl(events_path, skip_invalid=True)
    fired_events = [e for e in alert_events
                    if e.get("rule") == "build_latency_burn"
                    and e.get("state") == "firing"]
    resolved_events = [e for e in alert_events
                      if e.get("rule") == "build_latency_burn"
                      and e.get("state") == "resolved"]
    gates["alert_events_recorded"] = bool(fired_events) \
        and bool(resolved_events)
    slo["alert_events"] = {"total": len(alert_events),
                           "fired": len(fired_events),
                           "resolved": len(resolved_events),
                           "path": events_path}
    slo["gates"] = gates
    report = {
        "schema": LOADGEN_SCHEMA,
        "mode": "slo-smoke",
        "config": {
            "workers": n_workers,
            "canary_interval_seconds": canary_interval,
            "slo_interval_seconds": slo_interval,
            "canary_slow_seconds": canary_slow_seconds,
            "fast_window_seconds": fast_window,
        },
        "slo": slo,
        "ok": all(gates.values()),
    }
    if args.report:
        metrics.write_json_atomic(args.report, report)
        log.info("slo-smoke report written to %s", args.report)
    print(render_slo_smoke(report), end="")
    if cleanup_work:
        shutil.rmtree(work_dir, ignore_errors=True)
    return 0 if report["ok"] else 1


def render_slo_smoke(report: dict) -> str:
    """Human digest of an SLO smoke run: one line per gate, then the
    timings the gates measured."""
    slo = report.get("slo", {})
    gates = slo.get("gates", {})
    lines = [
        f"slo-smoke: {'PASS' if report.get('ok') else 'FAIL'} "
        f"({sum(1 for v in gates.values() if v)}/{len(gates)} gates) "
        f"— victim {slo.get('victim', '?')}",
    ]
    for name, passed in sorted(gates.items()):
        lines.append(f"  [{'ok' if passed else 'FAIL'}] {name}")
    if slo.get("fired_seconds") is not None:
        lines.append(
            f"  alert fired {slo['fired_seconds']:.1f}s after wedge "
            f"(budget {slo.get('fire_deadline_seconds', 0):.1f}s)")
    if slo.get("resolved_seconds") is not None:
        lines.append(f"  alert resolved {slo['resolved_seconds']:.1f}s "
                     f"after slot release")
    if slo.get("routed_workers"):
        lines.append("  routed to " + " ".join(slo["routed_workers"])
                     + f"  (health_demoted × "
                       f"{slo.get('health_demoted_decisions', 0)})")
    ev = slo.get("alert_events") or {}
    if ev:
        lines.append(f"  alert events: {ev.get('fired', 0)} fired, "
                     f"{ev.get('resolved', 0)} resolved → "
                     f"{ev.get('path', '')}")
    return "\n".join(lines) + "\n"


# -- session-snapshot prewarm / kill -9 recovery smoke ----------------------


def _run_prewarm_smoke(args, device=None) -> int:
    """The session-snapshot plane's acceptance scenario, end to end on
    real surfaces (no test-only hooks):

    KILL LEG — one worker builds a context twice; the second build is
    the RESIDENT warm floor. The worker then dies the ``kill -9`` way:
    its listener stops and every in-memory session dies with it — no
    invalidation, no extra flush. The only durable warm state is the
    chunk-addressed snapshot ``finish_build`` checkpointed. A fresh
    worker over the same storage rebuilds the UNCHANGED context and
    must report ``warm_mode=restored``, reproduce the warm build's
    layer digests byte for byte, count a restore on ``/sessions``, and
    land within 2x of the resident floor (plus a 1s absolute allowance
    so a sub-second floor doesn't turn scheduler jitter into a flake).

    DRAIN LEG — a 2-worker fleet: after two builds pin a session
    holder, the holder is gracefully drained. The front door must
    checkpoint its sessions (``sessions_snapshotted`` in the drain
    response), and the next build must route to the OTHER worker with
    a ``prewarm`` verdict on the route-decision ledger — the target
    restored from the pushed snapshot before the build arrived — then
    report ``warm_mode=restored`` with digests identical to the
    holder's.

    Exit code is nonzero when any gate fails."""
    from makisu_tpu_torch.fleet import FleetServer, WorkerSpec
    from makisu_tpu_torch.fleet import peers as fleet_peers
    from makisu_tpu_torch.utils import history as history_mod
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer
    from makisu_tpu_torch.worker.client import _UnixHTTPConnection

    work_dir = args.work_dir or tempfile.mkdtemp(
        prefix="makisu-prewarm-smoke-")
    os.makedirs(work_dir, exist_ok=True)
    cleanup_work = not args.work_dir

    gates: dict[str, bool] = {}
    prewarm: dict = {}
    servers: list[WorkerServer] = []
    fleet_server = None

    def spawn(wid: str) -> WorkerServer:
        sock = os.path.join(work_dir, f"{wid}.sock")
        server = WorkerServer(
            sock, max_concurrent_builds=args.max_concurrent_builds,
            device=device)
        server.serve_background()
        servers.append(server)
        return server

    def wait_ready(socket_path: str) -> bool:
        client = WorkerClient(socket_path)
        deadline = time.monotonic() + args.ready_timeout
        while not client.ready():
            if time.monotonic() >= deadline:
                log.error("prewarm-smoke: %s never became ready",
                          socket_path)
                return False
            time.sleep(0.05)
        return True

    def build(socket_path: str, ctx: str, tag: str, root: str,
              storage: str, history: str):
        """One build; ``storage`` empty routes through a front door
        (which rewrites --storage per worker). Returns (exit code,
        wall seconds, terminal build record)."""
        client = WorkerClient(socket_path)
        argv = ["--log-level", "error", "--history-out", history,
                "build", ctx, "-t", tag, "--hasher", args.hasher,
                "--root", root]
        if storage:
            argv += ["--storage", storage]
        t0 = time.monotonic()
        reg_token = metrics.set_build_registry(
            metrics.MetricsRegistry())
        try:
            code = client.build(argv, tenant="default")
        except (OSError, RuntimeError,
                http.client.HTTPException) as e:
            code = -1
            log.error("prewarm-smoke build %s failed to submit: %s",
                      tag, e)
        finally:
            metrics.reset_build_registry(reg_token)
        return code, time.monotonic() - t0, client.last_build or {}

    def last_warm_mode(history: str) -> str:
        records = history_mod.read_history(history)
        return str(records[-1].get("warm_mode", "")) \
            if records else ""

    def digests_of(storage: str, tag: str) -> list[str]:
        try:
            return _layer_digests(storage, tag)
        except (OSError, KeyError) as e:
            log.warning("prewarm-smoke: could not read digests for "
                        "%s: %s", tag, e)
            return []

    try:
        # ---- kill leg -------------------------------------------------
        storage = os.path.join(work_dir, "kill-storage")
        ctx = os.path.join(work_dir, "kill-ctx")
        _make_template(ctx, 0, args.files, args.file_kb)
        root = os.path.join(work_dir, "kill-root")
        os.makedirs(root, exist_ok=True)
        hist = os.path.join(work_dir, "kill-history.jsonl")
        w0 = spawn("kill-w0")
        if not wait_ready(w0.socket_path):
            return 1
        code0, cold_s, _ = build(w0.socket_path, ctx,
                                 "prewarm/kill:cold", root, storage,
                                 hist)
        code1, floor_s, _ = build(w0.socket_path, ctx,
                                  "prewarm/kill:warm", root, storage,
                                  hist)
        floor_mode = last_warm_mode(hist)
        warm_digests = digests_of(storage, "prewarm/kill:warm") \
            if code1 == 0 else []
        # The kill: stop the listener and DROP the process state.
        # Nothing is invalidated and nothing flushes beyond what
        # finish_build already checkpointed — the disk is exactly what
        # a SIGKILLed worker leaves behind.
        w0.shutdown()
        w0.server_close()
        servers.remove(w0)
        try:
            os.unlink(w0.socket_path)
        except OSError:
            pass

        w1 = spawn("kill-w1")
        if not wait_ready(w1.socket_path):
            return 1
        code2, restored_s, _ = build(w1.socket_path, ctx,
                                     "prewarm/kill:restored", root,
                                     storage, hist)
        restored_mode = last_warm_mode(hist)
        restored_digests = digests_of(storage,
                                      "prewarm/kill:restored") \
            if code2 == 0 else []
        try:
            snap_stats = (json.loads(_front_get(
                w1.socket_path, "/sessions")).get("snapshot") or {})
        except (OSError, ValueError):
            snap_stats = {}
        budget_s = max(2.0 * floor_s, floor_s + 1.0)
        gates["kill_builds_succeeded"] = \
            code0 == 0 and code1 == 0 and code2 == 0
        gates["kill_floor_resident"] = floor_mode == "resident"
        gates["kill_warm_mode_restored"] = restored_mode == "restored"
        gates["kill_digest_identity"] = bool(warm_digests) \
            and restored_digests == warm_digests
        gates["kill_restore_counted"] = \
            int(snap_stats.get("restore", 0)) >= 1
        gates["kill_within_2x_floor"] = \
            code2 == 0 and restored_s <= budget_s
        prewarm["kill"] = {
            "cold_seconds": round(cold_s, 3),
            "floor_seconds": round(floor_s, 3),
            "restored_seconds": round(restored_s, 3),
            "budget_seconds": round(budget_s, 3),
            "floor_mode": floor_mode,
            "restored_mode": restored_mode,
            "layers": len(warm_digests),
            "snapshot_counts": snap_stats,
        }
        w1.shutdown()
        w1.server_close()
        servers.remove(w1)
        fleet_peers.reset()

        # ---- drain leg ------------------------------------------------
        specs = []
        for i in range(2):
            wid = f"drain-w{i}"
            server = spawn(wid)
            specs.append(WorkerSpec(
                wid, server.socket_path,
                os.path.join(work_dir, f"{wid}-storage")))
        for spec in specs:
            if not wait_ready(spec.socket_path):
                return 1
        fleet_server = FleetServer(
            os.path.join(work_dir, "fleet.sock"), specs,
            poll_interval=0.25)
        fleet_server.serve_background()
        if not wait_ready(fleet_server.socket_path):
            return 1
        storage_for = {spec.id: spec.storage for spec in specs}
        dctx = os.path.join(work_dir, "drain-ctx")
        _make_template(dctx, 1, args.files, args.file_kb)
        droot = os.path.join(work_dir, "drain-root")
        os.makedirs(droot, exist_ok=True)
        dhist = os.path.join(work_dir, "drain-history.jsonl")
        dcode0, _, _ = build(fleet_server.socket_path, dctx,
                             "prewarm/drain:b0", droot, "", dhist)
        dcode1, _, term1 = build(fleet_server.socket_path, dctx,
                                 "prewarm/drain:b1", droot, "", dhist)
        holder = str(term1.get("worker", ""))
        holder_digests = digests_of(storage_for.get(holder, ""),
                                    "prewarm/drain:b1") \
            if dcode1 == 0 and holder in storage_for else []
        drain_resp: dict = {}
        conn = _UnixHTTPConnection(fleet_server.socket_path, 30.0)
        try:
            conn.request(
                "POST", "/drain",
                body=json.dumps({"worker": holder}).encode(),
                headers={"Content-Type": "application/json"})
            drain_resp = json.loads(
                conn.getresponse().read() or b"{}")
        except (OSError, ValueError) as e:
            log.error("prewarm-smoke drain failed: %s", e)
        finally:
            conn.close()
        dcode2, _, term2 = build(fleet_server.socket_path, dctx,
                                 "prewarm/drain:b2", droot, "", dhist)
        target = str(term2.get("worker", ""))
        drain_mode = last_warm_mode(dhist)
        target_digests = digests_of(storage_for.get(target, ""),
                                    "prewarm/drain:b2") \
            if dcode2 == 0 and target in storage_for else []
        try:
            fleet_stats = json.loads(_front_get(
                fleet_server.socket_path, "/fleet"))
        except (OSError, ValueError):
            fleet_stats = {}
        prewarms = [d for d in fleet_stats.get(
            "recent_decisions", [])
            if d.get("verdict") == "prewarm"
            and d.get("worker") == target]
        gates["drain_builds_succeeded"] = \
            dcode0 == 0 and dcode1 == 0 and dcode2 == 0
        gates["drain_sessions_snapshotted"] = \
            int(drain_resp.get("sessions_snapshotted", 0)) >= 1
        gates["drain_routed_off_holder"] = \
            bool(target) and target != holder
        gates["drain_prewarm_recorded"] = bool(prewarms)
        gates["drain_warm_mode_restored"] = drain_mode == "restored"
        gates["drain_digest_identity"] = bool(holder_digests) \
            and target_digests == holder_digests
        prewarm["drain"] = {
            "holder": holder,
            "target": target,
            "sessions_snapshotted": int(
                drain_resp.get("sessions_snapshotted", 0)),
            "prewarm_decisions": len(prewarms),
            "mode": drain_mode,
            "route_totals": fleet_stats.get("route_totals", {}),
        }
    finally:
        if fleet_server is not None:
            fleet_server.shutdown()
            fleet_server.server_close()
        for server in servers:
            server.shutdown()
            server.server_close()
        fleet_peers.reset()

    prewarm["gates"] = gates
    report = {
        "schema": LOADGEN_SCHEMA,
        "mode": "prewarm-smoke",
        "config": {
            "files": args.files,
            "file_kb": args.file_kb,
            "hasher": args.hasher,
        },
        "prewarm": prewarm,
        "ok": bool(gates) and all(gates.values()),
    }
    if args.report:
        metrics.write_json_atomic(args.report, report)
        log.info("prewarm-smoke report written to %s", args.report)
    print(render_prewarm_smoke(report), end="")
    if cleanup_work:
        shutil.rmtree(work_dir, ignore_errors=True)
    return 0 if report["ok"] else 1


def render_prewarm_smoke(report: dict) -> str:
    """Human digest of a prewarm smoke run: one line per gate, then
    the recovery timings and the drain hand-off the gates measured."""
    pw = report.get("prewarm", {})
    gates = pw.get("gates", {})
    lines = [
        f"prewarm-smoke: {'PASS' if report.get('ok') else 'FAIL'} "
        f"({sum(1 for v in gates.values() if v)}/{len(gates)} gates)",
    ]
    for name, passed in sorted(gates.items()):
        lines.append(f"  [{'ok' if passed else 'FAIL'}] {name}")
    kill = pw.get("kill") or {}
    if kill:
        lines.append(
            f"  kill -9 recovery: cold {kill.get('cold_seconds', 0):.3f}s, "
            f"resident floor {kill.get('floor_seconds', 0):.3f}s, "
            f"restored rebuild {kill.get('restored_seconds', 0):.3f}s "
            f"(budget {kill.get('budget_seconds', 0):.3f}s, "
            f"mode {kill.get('restored_mode', '?')})")
    drain = pw.get("drain") or {}
    if drain:
        lines.append(
            f"  drain hand-off: {drain.get('holder', '?')} → "
            f"{drain.get('target', '?')}  "
            f"snapshotted {drain.get('sessions_snapshotted', 0)}, "
            f"prewarm decisions {drain.get('prewarm_decisions', 0)}, "
            f"mode {drain.get('mode', '?')}")
    return "\n".join(lines) + "\n"


def _run_evict_soak(args, device=None) -> int:
    """The content store's acceptance scenario: the SAME edited-
    rebuild stream runs against two storages — one carrying a tiny
    byte budget (the subject, evicting every build) and one
    unbudgeted (the oracle). Gates:

    - evictions actually fired on the subject
      (``makisu_storage_evictions_total`` delta > 0);
    - the subject's disk high-water reaches steady state — the later
      rounds' peak stays within 25% of the earlier rounds' peak
      instead of growing monotonically like the oracle's;
    - every round's layer digests are byte-identical to the
      unbudgeted oracle's (eviction never changes build output);
    - a post-soak integrity scrub over the evicted store reports
      ZERO corruption findings, and the audit reports zero errors.

    Exit code is nonzero when any gate fails."""
    from makisu_tpu_torch.cache import census as census_mod
    from makisu_tpu_torch.storage import contentstore
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer

    work_dir = args.work_dir or tempfile.mkdtemp(
        prefix="makisu-evict-soak-")
    os.makedirs(work_dir, exist_ok=True)
    cleanup_work = not args.work_dir

    rounds = args.rounds if args.rounds >= 4 else 6
    subject = os.path.join(work_dir, "subject-storage")
    oracle = os.path.join(work_dir, "oracle-storage")
    ctx = os.path.join(work_dir, "soak-ctx")
    _make_template(ctx, 0, args.files, args.file_kb)
    root = os.path.join(work_dir, "soak-root")
    os.makedirs(root, exist_ok=True)
    hist = os.path.join(work_dir, "soak-history.jsonl")

    # Tiny budget: about a third of one context's source bytes, so a
    # couple of rounds of churn overflow it and the evictor must hold
    # the line for the rest of the soak.
    budget_bytes = max(16 << 10,
                       (args.files * args.file_kb << 10) // 3)
    contentstore.set_budget_for(subject, budget_bytes)
    # A remote tier for the subject so cold packs always have
    # somewhere to demote — even on a libzstd-less host where no
    # compressed twins exist (the raw-pack demotion path).
    prev_remote = contentstore.remote_tier_dir()
    contentstore.configure(
        remote=os.path.join(work_dir, "remote-tier"))
    prev_evict_env = os.environ.get("MAKISU_TPU_STORAGE_EVICT_SECONDS")
    os.environ["MAKISU_TPU_STORAGE_EVICT_SECONDS"] = "0"

    gates: dict[str, bool] = {}
    soak: dict = {"rounds": [], "budget_bytes": budget_bytes}
    counters0 = contentstore.counters()
    server = WorkerServer(
        os.path.join(work_dir, "soak.sock"),
        max_concurrent_builds=args.max_concurrent_builds, device=device)
    server.serve_background()

    def build(storage: str, tag: str) -> int:
        client = WorkerClient(server.socket_path)
        argv = ["--log-level", "error", "--history-out", hist,
                "build", ctx, "-t", tag, "--hasher", args.hasher,
                "--root", root, "--storage", storage]
        reg_token = metrics.set_build_registry(
            metrics.MetricsRegistry())
        try:
            return client.build(argv, tenant="default")
        except (OSError, RuntimeError,
                http.client.HTTPException) as e:
            log.error("evict-soak build %s failed to submit: %s",
                      tag, e)
            return -1
        finally:
            metrics.reset_build_registry(reg_token)

    def hot_bytes(storage: str) -> int:
        return contentstore.store_for(storage).tier_bytes(
            publish=False)["hot"]

    try:
        client = WorkerClient(server.socket_path)
        deadline = time.monotonic() + args.ready_timeout
        while not client.ready():
            if time.monotonic() >= deadline:
                log.error("evict-soak: worker never became ready")
                return 1
            time.sleep(0.05)

        codes_ok = True
        digests_ok = True
        for r in range(rounds):
            if r:
                _edit_files(ctx, args.edit_churn, f"round-{r}")
            tag = f"soak/ctx:r{r}"
            sc = build(subject, tag)
            s_digests = _layer_digests(subject, tag) if sc == 0 else []
            oc = build(oracle, tag)
            o_digests = _layer_digests(oracle, tag) if oc == 0 else []
            codes_ok = codes_ok and sc == 0 and oc == 0
            digests_ok = digests_ok and bool(o_digests) \
                and s_digests == o_digests
            soak["rounds"].append({
                "round": r,
                "subject_exit": sc,
                "oracle_exit": oc,
                "digests_match": bool(o_digests)
                and s_digests == o_digests,
                "subject_hot_bytes": hot_bytes(subject),
                "oracle_hot_bytes": hot_bytes(oracle),
            })
    finally:
        server.shutdown()
        server.server_close()
        contentstore.configure(remote=prev_remote or "")
        if prev_evict_env is None:
            os.environ.pop("MAKISU_TPU_STORAGE_EVICT_SECONDS", None)
        else:
            os.environ["MAKISU_TPU_STORAGE_EVICT_SECONDS"] = \
                prev_evict_env

    counters1 = contentstore.counters()
    evictions = int(counters1["evictions"] - counters0["evictions"])
    highs = [row["subject_hot_bytes"] for row in soak["rounds"]]
    half = max(1, len(highs) // 2)
    early_peak = max(highs[:half]) if highs else 0
    late_peak = max(highs[half:]) if highs[half:] else 0
    subject_census = census_mod.StorageCensus(subject)
    audit = subject_census.audit()
    scrub = subject_census.scrub(chunk_samples=64, pack_samples=4)
    audit_errors = [f for f in audit.get("findings", [])
                    if f.get("severity") == "error"]

    gates["builds_succeeded"] = codes_ok
    gates["evictions_fired"] = evictions > 0
    gates["high_water_steady"] = early_peak > 0 \
        and late_peak <= early_peak * 1.25
    gates["digests_match_oracle"] = digests_ok
    gates["scrub_clean"] = not scrub.get("findings")
    gates["audit_clean"] = not audit_errors

    soak["gates"] = gates
    soak["evictions"] = evictions
    soak["evicted_bytes"] = int(
        counters1["evicted_bytes"] - counters0["evicted_bytes"])
    soak["refetch_bytes"] = int(
        counters1["refetch_bytes"] - counters0["refetch_bytes"])
    soak["early_peak_bytes"] = early_peak
    soak["late_peak_bytes"] = late_peak
    soak["oracle_final_bytes"] = \
        soak["rounds"][-1]["oracle_hot_bytes"] if soak["rounds"] else 0
    soak["scrub"] = {k: scrub[k] for k in
                     ("chunks_checked", "packs_checked")
                     if k in scrub}
    soak["scrub"]["findings"] = len(scrub.get("findings", []))
    soak["audit_errors"] = len(audit_errors)
    soak["contentstore"] = contentstore.store_for(subject).describe()

    report = {
        "schema": LOADGEN_SCHEMA,
        "mode": "evict-soak",
        "config": {
            "rounds": rounds,
            "files": args.files,
            "file_kb": args.file_kb,
            "edit_churn": args.edit_churn,
            "budget_bytes": budget_bytes,
            "hasher": args.hasher,
        },
        "evict_soak": soak,
        "ok": bool(gates) and all(gates.values()),
    }
    if args.report:
        metrics.write_json_atomic(args.report, report)
        log.info("evict-soak report written to %s", args.report)
    print(render_evict_soak(report), end="")
    if cleanup_work:
        shutil.rmtree(work_dir, ignore_errors=True)
    return 0 if report["ok"] else 1


def render_evict_soak(report: dict) -> str:
    """Human digest of an eviction soak: gates, then the disk
    high-water trajectory and eviction/refetch volumes they gated."""
    soak = report.get("evict_soak", {})
    gates = soak.get("gates", {})
    lines = [
        f"evict-soak: {'PASS' if report.get('ok') else 'FAIL'} "
        f"({sum(1 for v in gates.values() if v)}/{len(gates)} gates)",
    ]
    for name, passed in sorted(gates.items()):
        lines.append(f"  [{'ok' if passed else 'FAIL'}] {name}")
    lines.append(
        f"  budget {soak.get('budget_bytes', 0)}B: high-water "
        f"{soak.get('early_peak_bytes', 0)}B early → "
        f"{soak.get('late_peak_bytes', 0)}B late "
        f"(oracle grew to {soak.get('oracle_final_bytes', 0)}B)")
    lines.append(
        f"  evictions {soak.get('evictions', 0)} "
        f"({soak.get('evicted_bytes', 0)}B out, "
        f"{soak.get('refetch_bytes', 0)}B refetched), "
        f"scrub findings {soak.get('scrub', {}).get('findings', 0)}, "
        f"audit errors {soak.get('audit_errors', 0)}")
    return "\n".join(lines) + "\n"


def _front_get(socket_path: str, path: str) -> bytes:
    from makisu_tpu_torch.worker.client import _UnixHTTPConnection
    conn = _UnixHTTPConnection(socket_path, 10.0)
    try:
        conn.request("GET", path)
        return conn.getresponse().read()
    finally:
        conn.close()


def _build_fleet_report(args, results, baseline_results, disruption,
                        fleet_stats, sampler, wall, baseline_wall,
                        tenants, n_workers, n_ctx, rounds,
                        registry, fleet_metrics_text="") -> dict:
    ok_rows = [r for r in results if r["exit_code"] == 0]
    latencies = [r["latency_seconds"] for r in ok_rows]
    base_ok = [r for r in baseline_results if r["exit_code"] == 0]
    base_latencies = [r["latency_seconds"] for r in base_ok]
    # Per-worker build distribution.
    distribution: dict[str, int] = {}
    for r in ok_rows:
        if r["worker"]:
            distribution[r["worker"]] = \
                distribution.get(r["worker"], 0) + 1
    # Affinity hit-rate over post-warmup builds. "Eligible" excludes
    # builds whose session holder had been drained/killed by the time
    # they routed (the disruption lands between rounds 1 and 2) —
    # those CANNOT route affinity, and the metric is "routes to the
    # session holder when one exists". The excluded ones are counted
    # separately as relocations.
    disrupted = {disruption.get("drained", ""),
                 disruption.get("killed", "")} - {""}
    warm = [r for r in ok_rows if r["round"] >= 1]
    prior_holder: dict[tuple, str] = {}
    for r in sorted(results, key=lambda r: (r["context"], r["round"])):
        prior_holder[(r["context"], r["round"] + 1)] = r["worker"]

    def relocated(row) -> bool:
        return (row["round"] >= 2
                and prior_holder.get((row["context"], row["round"]),
                                     "") in disrupted)

    eligible = [r for r in warm if not relocated(r)]
    affinity_all = sum(1 for r in warm if r["verdict"] == "affinity")
    affinity_eligible = sum(1 for r in eligible
                            if r["verdict"] == "affinity")
    relocations = sum(1 for r in warm if relocated(r))
    # Digest identity: rounds >= 2 rebuild UNCHANGED content, so each
    # build's digests must equal the same context's round-1 digests —
    # across relocation, failover, and peer-fetched chunks. A row that
    # CANNOT be compared (its digests were unreadable, or its context
    # has no round-1 reference) counts as UNVERIFIED and fails the
    # gate too: "identical" must never be a vacuous pass.
    reference: dict[int, list] = {
        r["context"]: r["digests"] for r in ok_rows
        if r["round"] == 1 and r["digests"]}
    comparable = [r for r in ok_rows if r["round"] >= 2]
    unverified = [
        {"context": r["context"], "round": r["round"],
         "worker": r["worker"]}
        for r in comparable
        if not r["digests"] or reference.get(r["context"]) is None]
    mismatches = [
        {"context": r["context"], "round": r["round"],
         "worker": r["worker"]}
        for r in comparable
        if r["digests"]
        and reference.get(r["context"]) not in (None, r["digests"])]
    digest_identity = (bool(comparable) and not mismatches
                       and not unverified)
    route_totals = fleet_stats.get("route_totals", {})
    peer_hits = int(registry.counter_total(
        "makisu_fleet_peer_chunk_hits_total"))
    peer_bytes = int(registry.counter_total(
        "makisu_fleet_peer_chunk_bytes_total"))
    chunk_serves = int(registry.counter_total(
        "makisu_fleet_chunk_serves_total", result="hit"))
    # Pack-granular exchange telemetry (the distribution plane the
    # peer fetches now ride): the requests counter is the wire proof
    # that missing chunks moved as coalesced ranged pack reads, not
    # one GET per chunk.
    peer_pack_requests = int(registry.counter_total(
        metrics.SERVE_PEER_PACK_REQUESTS))
    peer_pack_bytes = int(registry.counter_total(
        metrics.SERVE_PEER_PACK_BYTES))
    pack_serves = int(registry.counter_total(
        metrics.SERVE_PACK_REQUESTS, kind="range")) + int(
        registry.counter_total(metrics.SERVE_PACK_REQUESTS,
                               kind="full"))
    fleet_p99 = metrics.percentile_stats(latencies).get("p99", 0.0)
    base_p99 = metrics.percentile_stats(base_latencies).get("p99", 0.0)
    failovers = [r for r in ok_rows if r["verdict"] == "failover"
                 or r["attempts"] > 1]
    return {
        "schema": LOADGEN_SCHEMA,
        "mode": "fleet",
        "config": {
            "workers": n_workers,
            "contexts": n_ctx,
            "rounds": rounds,
            "files": args.files,
            "file_kb": args.file_kb,
            "edit_churn": args.edit_churn,
            "tenants": tenants,
            "tenant_quota": args.tenant_quota,
            "hasher": args.hasher,
            "max_concurrent_builds": args.max_concurrent_builds,
        },
        "wall_seconds": round(wall, 3),
        "builds": len(results),
        "failures": sum(1 for r in results if r["exit_code"] != 0),
        "latency_seconds": metrics.percentile_stats(latencies),
        "queue_wait_seconds": metrics.percentile_stats(
            [r["queue_wait_seconds"] for r in ok_rows]),
        "exec_seconds": metrics.percentile_stats(
            [max(r["latency_seconds"] - r["queue_wait_seconds"]
                 - r["quota_wait_seconds"], 0.0) for r in ok_rows]),
        "cold_latency_seconds": metrics.percentile_stats(
            [r["latency_seconds"] for r in ok_rows
             if not r["warm"]]),
        "warm_latency_seconds": metrics.percentile_stats(
            [r["latency_seconds"] for r in ok_rows if r["warm"]]),
        "tenant_latency_seconds": {
            tenant: metrics.percentile_stats(
                [r["latency_seconds"] for r in ok_rows
                 if r["tenant"] == tenant])
            for tenant in tenants},
        # Parsed from the front door's AGGREGATED scrape — one target,
        # every worker's series under a worker label.
        "hash_batch_occupancy": _occupancy_from_metrics(
            fleet_metrics_text) if fleet_metrics_text else None,
        "queue_wait_share": 0.0,
        "tenant_fairness_p99_ratio": 1.0,
        "throughput_builds_per_s": round(len(results) / wall, 3)
        if wall else 0.0,
        "peak_inflight": sampler.peak_inflight if sampler else 0,
        "peak_queue_depth": sampler.peak_queue_depth if sampler else 0,
        "saw_running_build": bool(sampler
                                  and sampler.saw_running_build),
        "cache_trajectory": sampler.samples if sampler else [],
        "fleet": {
            "distribution": dict(sorted(distribution.items())),
            "affinity_hit_rate": round(
                affinity_all / len(warm), 4) if warm else 0.0,
            "affinity_hit_rate_eligible": round(
                affinity_eligible / len(eligible), 4)
            if eligible else 0.0,
            "route_totals": route_totals,
            "quota_denied": int(route_totals.get("quota_denied", 0)),
            "disruption": dict(disruption),
            "relocated_builds": relocations,
            "failover_builds": len(failovers),
            "digest_identity": digest_identity,
            "digest_mismatches": mismatches,
            "digest_unverified": unverified,
            "peer_chunk_hits": peer_hits,
            "peer_chunk_bytes": peer_bytes,
            "peer_chunk_serves": chunk_serves,
            "peer_pack_requests": peer_pack_requests,
            "peer_pack_bytes": peer_pack_bytes,
            "pack_serves": pack_serves,
            "baseline": {
                "wall_seconds": round(baseline_wall, 3),
                "builds": len(baseline_results),
                "failures": sum(1 for r in baseline_results
                                if r["exit_code"] != 0),
                "latency_seconds": metrics.percentile_stats(
                    base_latencies),
            },
            "p99_seconds": fleet_p99,
            "baseline_p99_seconds": base_p99,
            "p99_delta_seconds": round(fleet_p99 - base_p99, 3),
            "p99_ratio": round(fleet_p99 / base_p99, 3)
            if base_p99 else 0.0,
            "workers": fleet_stats.get("workers", []),
            # Distinct worker labels seen in the front door's
            # aggregated /metrics scrape — proof the re-export fanned
            # out (survivors only; dead/killed workers scrape as
            # errors, not silence).
            "aggregated_scrape_workers": sorted(set(
                re.findall(r'worker="([^"]+)"',
                           fleet_metrics_text))),
        },
        "results": results,
        "baseline_results": baseline_results,
    }
