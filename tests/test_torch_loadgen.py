"""The port's tools (``makisu_tpu_torch/tools/``: ``loadgen``, ``top``,
``mkrootfs``) on the CPU, held against the JAX package's.

The cases of ``tests/test_loadgen.py`` run on port workers on
``device="cpu"`` (loadgen's ``run(args, device="cpu")``; their
``--hasher gpu`` builds run the kernels' plain versions). Then each of
loadgen's five modes runs with exit 0: the single worker, ``--fleet``
(2 workers: the drain; 3 workers: the drain and the kill, every digest
identical), ``--slo-smoke``, ``--prewarm-smoke`` and ``--evict-soak``.
The generated templates, the metric parse and the rendered text equal
the reference's on the same inputs. Tolerance: none.
"""

import json
import os
import re

import pytest

from makisu_tpu import cli as ref_cli
from makisu_tpu.fleet import peers as ref_peers
from makisu_tpu.tools import loadgen as ref_loadgen
from makisu_tpu.tools import top as ref_top
from makisu_tpu_torch import cli
from makisu_tpu_torch.fleet import peers as fleet_peers
from makisu_tpu_torch.serve import server as serve_server
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.tools import loadgen, mkrootfs, top
from makisu_tpu_torch.utils import mountinfo
from makisu_tpu_torch.worker import WorkerClient, WorkerServer, session


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    """Empty peer maps and serve registries, no host mount table, no
    one-second wait before a commit, and what a worker turns on for its
    process (MAKISU_TPU_SHARED_HASH, recipe publishing) restored after
    each test. Sessions track their contexts by mtime walks, not inotify:
    the harness's many workers would otherwise spend the per-user inotify
    budget (128) that every test process shares."""
    monkeypatch.setenv("MAKISU_TPU_SESSION_MAX_WATCHES", "0")
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")
    monkeypatch.setattr(serve_server, "_publishing", serve_server._publishing)
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    mountinfo.set_mountpoints_for_testing(set())
    for mod in (fleet_peers, ref_peers):
        mod.reset()
    serve_server.reset_stores()
    yield
    # A direct build's resident session holds an inotify instance, a
    # per-user budget every test process shares.
    session.manager().reset()
    for mod in (fleet_peers, ref_peers):
        mod.reset()
    serve_server.reset_stores()
    mountinfo.set_mountpoints_for_testing(None)


def _loadgen_args(extra):
    return cli.make_parser().parse_args(
        ["--log-level", "error", "loadgen"] + extra)


def test_loadgen_smoke_against_live_worker(tmp_path):
    """A small run against a live in-process worker: every build
    succeeds, and the report carries latency digests, the queue-wait
    split, per-tenant fairness and the in-flight builds seen."""
    server = WorkerServer(str(tmp_path / "lg.sock"), device="cpu",
                          max_concurrent_builds=2)
    server.serve_background()
    report_path = tmp_path / "report.json"
    try:
        args = _loadgen_args([
            "--socket", server.socket_path, "--concurrency", "3",
            "--builds", "6", "--files", "4", "--file-kb", "1",
            "--edit-churn", "0.5", "--tenants", "red,blue",
            "--poll-interval", "0.05", "--report", str(report_path),
            "--work-dir", str(tmp_path / "work")])
        assert args.hasher == "gpu"
        assert loadgen.run(args, device="cpu") == 0
    finally:
        server.shutdown()
        server.server_close()
    report = json.loads(report_path.read_text())
    assert report["schema"] == "makisu-tpu.loadgen.v1"
    assert report["builds"] == 6 and report["failures"] == 0
    assert report["config"]["hasher"] == "gpu"
    lat = report["latency_seconds"]
    assert lat["count"] == 6 and 0 < lat["p50"] <= lat["p99"]
    for row in report["results"]:
        assert row["exit_code"] == 0
        assert row["latency_seconds"] >= row["queue_wait_seconds"]
        assert abs(row["queue_wait_seconds"] + row["exec_seconds"]
                   - row["latency_seconds"]) < 0.05
    tenants = report["tenant_latency_seconds"]
    assert set(tenants) == {"red", "blue"}
    assert sum(s["count"] for s in tenants.values()) == 6
    assert report["tenant_fairness_p99_ratio"] >= 1.0
    assert report["saw_running_build"] and report["peak_inflight"] >= 1
    assert report["peak_queue_depth"] >= 1 \
        or report["queue_wait_seconds"]["max"] > 0
    last = report["cache_trajectory"][-1]
    assert last["cache_hits"] + last["cache_misses"] > 0
    assert last["cache_hits"] > 0
    assert report["worker_health"]["builds_started"] >= 6
    # The builds' ring passes went through the shared hash service.
    assert report["hash_batch_occupancy"]["batches"] >= 1


def test_loadgen_spawns_own_worker(tmp_path):
    report_path = tmp_path / "spawned.json"
    args = _loadgen_args([
        "--concurrency", "2", "--builds", "2", "--files", "3",
        "--file-kb", "1", "--max-concurrent-builds", "1",
        "--poll-interval", "0.05", "--report", str(report_path),
        "--work-dir", str(tmp_path / "work")])
    assert loadgen.run(args, device="cpu") == 0
    report = json.loads(report_path.read_text())
    assert report["builds"] == 2 and report["failures"] == 0
    assert report["config"]["max_concurrent_builds"] == 1


def test_loadgen_spawned_worker_runs_on_the_card_by_default(tmp_path,
                                                            monkeypatch):
    """No fallback: with no device named, the spawned worker is the
    card's, and on a host without CUDA the run fails."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is the card")
    monkeypatch.delenv("MAKISU_TPU_WORKER_WARM_PROBE", raising=False)
    assert cli.main(["--log-level", "error", "loadgen", "--builds", "1",
                     "--concurrency", "1", "--files", "1", "--file-kb",
                     "1", "--work-dir", str(tmp_path / "w")]) == 1


def test_hasher_choices():
    assert _loadgen_args([]).hasher == "gpu"
    assert _loadgen_args(["--hasher", "cpu"]).hasher == "cpu"
    with pytest.raises(SystemExit) as exc:
        _loadgen_args(["--hasher", "tpu"])
    assert exc.value.code == 2


def test_make_template_and_edit_churn(tmp_path):
    loadgen._make_template(str(tmp_path / "p"), 0, files=5, file_kb=1)
    ref_loadgen._make_template(str(tmp_path / "r"), 0, files=5, file_kb=1)

    def tree(root):
        return {os.path.relpath(os.path.join(d, f), root):
                open(os.path.join(d, f), "rb").read()
                for d, _, files in os.walk(root) for f in files}

    assert tree(tmp_path / "p") == tree(tmp_path / "r")
    src = tmp_path / "p" / "src"
    assert len(list(src.iterdir())) == 5
    assert "COPY base/ /base/" in (tmp_path / "p" / "Dockerfile").read_text()
    before = {p.name: p.read_text() for p in src.iterdir()}
    assert loadgen._edit_files(str(tmp_path / "p"), 0.4, "s1") == 2
    assert ref_loadgen._edit_files(str(tmp_path / "r"), 0.4, "s1") == 2
    after = {p.name: p.read_text() for p in src.iterdir()}
    assert len([n for n in before if before[n] != after[n]]) == 2
    assert tree(tmp_path / "p") == tree(tmp_path / "r")
    assert (tmp_path / "p" / "base" / "vendor.txt").read_text().startswith(
        "# template 0")
    assert loadgen._edit_files(str(tmp_path / "p"), 0.0, "s2") == 0


def test_occupancy_parse():
    text = (
        '# TYPE makisu_hash_batch_occupancy histogram\n'
        'makisu_hash_batch_occupancy_bucket{bucket="16384",le="0.5"} 3\n'
        'makisu_hash_batch_occupancy_sum{bucket="16384"} 1.5\n'
        'makisu_hash_batch_occupancy_count{bucket="16384"} 3\n'
        'makisu_hash_batch_occupancy_sum{bucket="262144"} 0.5\n'
        'makisu_hash_batch_occupancy_count{bucket="262144"} 1\n')
    occ = loadgen._occupancy_from_metrics(text)
    assert occ == {"batches": 4, "mean_occupancy": 0.5}
    assert occ == ref_loadgen._occupancy_from_metrics(text)
    assert loadgen._occupancy_from_metrics("") is None


_CANNED_REPORT = {
    "schema": loadgen.LOADGEN_SCHEMA,
    "builds": 4, "failures": 1, "wall_seconds": 10.0,
    "throughput_builds_per_s": 0.4,
    "latency_seconds": {"count": 3, "p50": 1.0, "p90": 2.0, "p99": 2.0,
                        "max": 2.0},
    "queue_wait_seconds": {"count": 3, "p50": 0.5, "p90": 1.0, "p99": 1.0,
                           "max": 1.0},
    "exec_seconds": {"count": 3, "p50": 0.5, "p90": 1.0, "p99": 1.0,
                     "max": 1.0},
    "queue_wait_share": 0.5,
    "cold_latency_seconds": {"count": 1, "p50": 2.0, "p90": 2.0,
                             "p99": 2.0, "max": 2.0},
    "warm_latency_seconds": {"count": 2, "p50": 1.0, "p90": 1.0,
                             "p99": 1.0, "max": 1.0},
    "tenant_latency_seconds": {
        "a": {"count": 2, "p50": 1.0, "p90": 2.0, "p99": 2.0, "max": 2.0},
        "b": {"count": 1, "p50": 1.0, "p90": 1.0, "p99": 1.0, "max": 1.0}},
    "tenant_fairness_p99_ratio": 2.0,
    "hash_batch_occupancy": {"batches": 7, "mean_occupancy": 0.25},
    "cache_trajectory": [{"cache_hit_ratio": 0.0},
                         {"cache_hit_ratio": 0.5}],
    "peak_inflight": 3, "peak_queue_depth": 2,
}


def test_render_report_digest():
    text = loadgen.render_report(_CANNED_REPORT)
    assert "4 builds (1 failed)" in text
    assert "p99   2.000s" in text
    assert "share 50.0%" in text
    assert "fairness (max/min tenant p99): 2.00" in text
    assert "occupancy: 25.0% over 7 batches" in text
    assert "0% → 50%" in text
    assert "peak in-flight 3, peak queue depth 2" in text
    assert text == ref_loadgen.render_report(_CANNED_REPORT)


def test_loadgen_worker_not_reachable(tmp_path):
    args = _loadgen_args([
        "--socket", str(tmp_path / "nope.sock"), "--concurrency", "1",
        "--builds", "1", "--ready-timeout", "0.2",
        "--work-dir", str(tmp_path / "work")])
    assert loadgen.run(args, device="cpu") == 1


def test_top_renders_live_worker(tmp_path, capsys):
    server = WorkerServer(str(tmp_path / "top.sock"), device="cpu")
    server.serve_background()
    try:
        ctx = tmp_path / "ctx"
        ctx.mkdir()
        (ctx / "Dockerfile").write_text("FROM scratch\nCOPY f /f\n")
        (ctx / "f").write_text("x")
        (tmp_path / "root").mkdir()
        client = WorkerClient(server.socket_path)
        assert client.build([
            "--log-level", "error", "build", str(ctx), "-t", "top/t:1",
            "--hasher", "cpu", "--storage", str(tmp_path / "s"),
            "--root", str(tmp_path / "root")], tenant="ops") == 0
        assert cli.main(["top", "--socket", server.socket_path,
                         "--once"]) == 0
        out = capsys.readouterr().out
        # The reference's top reads the port's worker the same way.
        assert ref_cli.main(["top", "--socket", server.socket_path,
                             "--once"]) == 0
        ref_out = capsys.readouterr().out
    finally:
        server.shutdown()
        server.server_close()
    assert "makisu-tpu top" in out
    assert "queue wait p50/p99" in out
    assert "(no builds in flight)" in out
    assert "ops" in out and "top/t:1" in out
    # The frames differ only where time moved between the two polls.
    strip = lambda s: re.sub(r"\d+(\.\d+)?", "N", s)  # noqa: E731
    assert strip(out) == strip(ref_out)


def test_top_unreachable_socket(tmp_path, capsys):
    assert cli.main(["top", "--socket", str(tmp_path / "no.sock"),
                     "--once"]) == 1
    assert "not reachable" in capsys.readouterr().out


def test_render_top_canned():
    health = {
        "uptime_seconds": 4000.0, "active_builds": 1,
        "builds_succeeded": 5, "builds_failed": 1,
        "last_progress_seconds": 0.4,
        "transfer_inflight_bytes": 2 * 1024 * 1024,
        "queue": {"depth": 2, "max_concurrent_builds": 2,
                  "wait_seconds": {"count": 6, "p50": 0.1, "p99": 1.5},
                  "latency_seconds": {"count": 6, "p50": 3.0,
                                      "p99": 9.0}},
    }
    builds = {
        "queue_depth": 2, "max_concurrent_builds": 2,
        "inflight": [
            {"id": 7, "tenant": "acme", "state": "running",
             "phase": "hash", "queue_wait_seconds": 0.2,
             "age_seconds": 12.0, "progress_age_seconds": 0.1,
             "cache": {"kv_consults": 4, "kv_hits": 3,
                       "kv_hit_ratio": 0.75}, "tag": "acme/app:dev"},
            {"id": 8, "tenant": "", "state": "queued", "phase": "",
             "queue_wait_seconds": 5.0, "age_seconds": 5.0,
             "progress_age_seconds": 5.0, "cache": {}, "tag": "x/y:1"}],
        "recent": [{"id": 6, "tenant": "acme", "exit_code": 0,
                    "queue_wait_seconds": 0.0, "elapsed_seconds": 2.5,
                    "tag": "acme/app:dev"}],
    }
    frame = top.render_top(health, builds, "/run/w.sock")
    assert "queued 2/cap 2" in frame and "1h06m" in frame
    assert "running" in frame and "queued" in frame
    assert "hash" in frame and "75%" in frame
    assert "2.0MiB" in frame and "recent:" in frame and "ok" in frame
    assert frame == ref_top.render_top(health, builds, "/run/w.sock")


def test_loadgen_fleet_mode(tmp_path):
    """Compact ``--fleet`` run (2 workers: the drain fires, the kill is
    skipped to keep a routable worker): every build succeeds, round 1
    routes back to each session holder, the drained context relocates
    and takes its chunks from a peer, with identical digests."""
    report_path = tmp_path / "fleet-report.json"
    args = _loadgen_args([
        "--fleet", "--workers", "2", "--contexts", "2", "--rounds", "3",
        "--files", "3", "--file-kb", "1", "--tenants", "red,blue",
        "--tenant-quota", "1", "--poll-interval", "0.1",
        "--report", str(report_path), "--work-dir", str(tmp_path / "work")])
    assert loadgen.run(args, device="cpu") == 0
    report = json.loads(report_path.read_text())
    assert report["schema"] == "makisu-tpu.loadgen.v1"
    assert report["mode"] == "fleet"
    assert report["builds"] == 6 and report["failures"] == 0
    assert len(report["baseline_results"]) == 6
    fleet = report["fleet"]
    assert fleet["affinity_hit_rate_eligible"] >= 0.5
    assert fleet["route_totals"].get("affinity", 0) >= 1
    assert fleet["disruption"]["drained"]
    assert fleet["relocated_builds"] >= 1
    assert fleet["peer_chunk_hits"] >= 1 and fleet["peer_chunk_bytes"] > 0
    assert fleet["digest_identity"] and fleet["digest_mismatches"] == []
    assert len(fleet["distribution"]) == 2
    assert fleet["baseline"]["latency_seconds"]["count"] == 6
    assert "p99_delta_seconds" in fleet
    tenants = report["tenant_latency_seconds"]
    assert {t for t, s in tenants.items() if s.get("count")} \
        == {"red", "blue"}


def test_loadgen_fleet_mode_drain_and_kill(tmp_path, capsys):
    """Three workers through the port's CLI: the drain and the kill
    both fire, the killed worker's contexts complete elsewhere (by
    relocation or a mid-route failover), and every rebuilt layer equals
    its round-1 digest; the quota made builds wait at the front door."""
    report_path = tmp_path / "fleet3.json"
    assert cli.main([
        "--log-level", "error", "loadgen", "--fleet", "--workers", "3",
        "--contexts", "3", "--rounds", "3", "--files", "3", "--file-kb",
        "1", "--tenants", "a,b", "--tenant-quota", "1", "--poll-interval",
        "0.1", "--report", str(report_path), "--work-dir",
        str(tmp_path / "work")], device="cpu") == 0
    fleet = json.loads(report_path.read_text())["fleet"]
    assert fleet["disruption"]["drained"] and fleet["disruption"]["killed"]
    assert fleet["disruption"]["drained"] != fleet["disruption"]["killed"]
    assert fleet["relocated_builds"] + fleet["failover_builds"] >= 1
    assert fleet["digest_identity"] and not fleet["digest_unverified"]
    assert fleet["quota_denied"] >= 1
    assert "digests identical" in capsys.readouterr().out


def test_loadgen_slo_smoke(tmp_path):
    """The SLO scenario on three port workers (cpu-hasher canaries):
    the burn alert fires on the wedged worker, routing shifts away with
    health_demoted decisions, healthy canaries agree, the alert
    resolves, and every gate holds."""
    report_path = tmp_path / "slo.json"
    events_path = tmp_path / "alerts.ndjson"
    args = _loadgen_args([
        "--slo-smoke", "--hasher", "cpu", "--report", str(report_path),
        "--alert-events-out", str(events_path),
        "--work-dir", str(tmp_path / "work")])
    assert loadgen.run(args, device="cpu") == 0
    report = json.loads(report_path.read_text())
    assert report["mode"] == "slo-smoke" and report["ok"]
    gates = report["slo"]["gates"]
    assert gates and all(gates.values()), gates
    assert report["slo"]["victim"] not in report["slo"]["routed_workers"]
    states = {json.loads(line)["state"]
              for line in events_path.read_text().splitlines()}
    assert {"firing", "resolved"} <= states


def test_loadgen_prewarm_smoke(tmp_path):
    """The session-snapshot scenario: a killed worker's resident session
    comes back restored on a fresh worker over the same storage, and a
    drained holder's next build lands prewarmed on the survivor."""
    report_path = tmp_path / "prewarm.json"
    args = _loadgen_args([
        "--prewarm-smoke", "--files", "3", "--file-kb", "1",
        "--report", str(report_path), "--work-dir", str(tmp_path / "work")])
    assert loadgen.run(args, device="cpu") == 0
    report = json.loads(report_path.read_text())
    assert report["mode"] == "prewarm-smoke" and report["ok"]
    prewarm = report["prewarm"]
    assert all(prewarm["gates"].values()), prewarm["gates"]
    assert prewarm["kill"]["restored_mode"] == "restored"
    assert prewarm["drain"]["prewarm_decisions"] >= 1


def test_loadgen_evict_soak(tmp_path):
    """The eviction soak: a tiny budget evicts, the disk reaches a
    steady high-water mark, every round's digests equal the unbudgeted
    oracle's, and the scrub finds nothing."""
    report_path = tmp_path / "soak.json"
    args = _loadgen_args([
        "--evict-soak", "--files", "3", "--file-kb", "1",
        "--report", str(report_path), "--work-dir", str(tmp_path / "work")])
    assert loadgen.run(args, device="cpu") == 0
    report = json.loads(report_path.read_text())
    assert report["mode"] == "evict-soak" and report["ok"]
    soak = report["evict_soak"]
    assert all(soak["gates"].values()), soak["gates"]
    assert soak["rounds"] and report["config"]["hasher"] == "gpu"


def test_mkrootfs_pulls_and_extracts(tmp_path, capsys):
    """mkrootfs: usage without arguments; with an image on a loopback
    registry, its rootfs lands in the destination directory."""
    from makisu_tpu_torch.tools.miniregistry import MiniRegistry
    assert mkrootfs.main([]) == 2
    assert "Usage" in capsys.readouterr().err
    ctx = tmp_path / "ctx"
    (ctx / "etc").mkdir(parents=True)
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY etc/ /etc/\n")
    (ctx / "etc" / "motd").write_text("hello from the rootfs\n")
    (tmp_path / "root").mkdir()
    with MiniRegistry() as reg:
        assert cli.main([
            "--log-level", "error", "build", str(ctx), "-t", "mk/fs:1",
            "--hasher", "cpu", "--storage", str(tmp_path / "s"),
            "--root", str(tmp_path / "root"), "--push", reg.addr],
            device="cpu") == 0
        dest = tmp_path / "rootfs"
        assert mkrootfs.main([f"{reg.addr}/mk/fs:1", str(dest),
                              str(tmp_path / "s2")]) == 0
    assert (dest / "etc" / "motd").read_text() == "hello from the rootfs\n"

