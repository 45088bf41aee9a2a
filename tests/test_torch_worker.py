"""The port's worker on the CPU (``WorkerServer(..., device="cpu")``: its
builds run the kernels' plain versions), held against the JAX package's
worker on ``JAX_PLATFORMS=cpu``: every case of ``tests/test_worker.py``,
``tests/test_worker_queue.py``, the worker's session and snapshot
endpoints, and the pure cases of ``tests/test_slo.py`` (run on both
packages' modules). Equal results: chunk lists and manifests of the same
build, the ``/healthz`` and ``/builds`` keys, the NDJSON frame kinds and
the ``alerts`` render text."""

import http.client
import io
import json
import os
import socket as socket_mod
import subprocess
import sys
import tarfile
import threading
import time

import numpy as np
import pytest

from makisu_tpu.fleet import slo as ref_slo
from makisu_tpu.utils import alerts as ref_alerts
from makisu_tpu.worker import WorkerClient as RefClient
from makisu_tpu.worker import WorkerServer as RefServer
from makisu_tpu.worker import session as ref_session
from makisu_tpu_torch.fleet import slo
from makisu_tpu_torch.utils import alerts as alerts_mod
from makisu_tpu_torch.utils import metrics, mountinfo
from makisu_tpu_torch.worker import WorkerClient, WorkerServer
from makisu_tpu_torch.worker import server as server_mod
from makisu_tpu_torch.worker import session as session_mod
from makisu_tpu_torch.worker import snapshots as snapshots_mod
from makisu_tpu_torch.worker.server import _AdmissionQueue

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Keys of the reference's /healthz that the port's worker does not serve
# (none: the storage plane is served too).
UNSERVED_HEALTH_KEYS: set[str] = set()


@pytest.fixture(autouse=True)
def _no_mounts():
    """Tmp build roots must not inherit the host's mount table."""
    mountinfo.set_mountpoints_for_testing(set())
    yield
    mountinfo.set_mountpoints_for_testing(None)


@pytest.fixture(autouse=True)
def _shared_hash_env(monkeypatch):
    """A worker sets MAKISU_TPU_SHARED_HASH=1 for its process; restored
    after each test so no later test's builds inherit it (a ``delenv`` of
    an absent variable records nothing to undo, so it is set to "0",
    which reads as off)."""
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")


def _serve(server):
    thread = server.serve_background()
    yield server
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


@pytest.fixture
def worker(tmp_path):
    yield from _serve(WorkerServer(str(tmp_path / "worker.sock"),
                                   device="cpu"))


@pytest.fixture
def ref_worker(tmp_path):
    yield from _serve(RefServer(str(tmp_path / "ref-worker.sock")))


@pytest.fixture
def capped_worker(tmp_path):
    """A worker that executes one build at a time; arrivals beyond it
    wait in the FIFO admission queue."""
    yield from _serve(WorkerServer(str(tmp_path / "capped.sock"),
                                   max_concurrent_builds=1, device="cpu"))


def _ctx(tmp_path, name, dockerfile, files):
    ctx = tmp_path / name
    ctx.mkdir()
    (ctx / "Dockerfile").write_text(dockerfile)
    for rel, data in files.items():
        (ctx / rel).write_bytes(data if isinstance(data, bytes)
                                else data.encode())
    return ctx


def _file_from_save_tar(tar_path, name):
    """One file's bytes out of a docker-save tar's layers."""
    with tarfile.open(tar_path) as tf:
        manifest = json.load(tf.extractfile("manifest.json"))
        for layer in reversed(manifest[0]["Layers"]):
            with tarfile.open(fileobj=io.BytesIO(
                    tf.extractfile(layer).read())) as lt:
                try:
                    return lt.extractfile(name).read()
                except KeyError:
                    continue
    raise KeyError(f"{name} not in any layer of {tar_path}")


def _kv_chunks(storage) -> dict:
    """cache key -> (chunks, tar digest, gzip digest) of every layer
    entry in a storage's KV file."""
    kv = json.loads((storage / "cache_key_value.json").read_text())
    return {k: (e["chunks"], e["tar"], e["gzip"])
            for k, e in ((k, json.loads(v)) for k, (v, _) in kv.items()
                         if v.startswith("{"))}


def _manifest_layers(storage, repo, tag):
    return json.loads((storage / "manifests" / repo / f"{tag}.json")
                      .read_text())["layers"]


# -- test_worker.py ------------------------------------------------------------


def test_ready(worker):
    assert WorkerClient(worker.socket_path).ready()


def test_not_ready_when_absent(tmp_path):
    assert not WorkerClient(str(tmp_path / "nope.sock")).ready()


def test_build_through_worker(tmp_path, worker, ref_worker):
    """The same gpu-hasher build through the port's worker and a
    tpu-hasher build through the reference's: the same chunk lists,
    cache IDs and manifest layers, and the port's ring pass went through
    the shared hash service."""
    from makisu_tpu_torch.chunker import service as service_mod
    data = np.random.default_rng(3).integers(
        0, 256, size=150_000, dtype=np.uint8).tobytes()
    ctx = _ctx(tmp_path, "ctx", "FROM scratch\nCOPY data.bin /data.bin\n",
               {"data.bin": data})
    out = {}
    for name, client, hasher in (
            ("port", WorkerClient(worker.socket_path), "gpu"),
            ("ref", RefClient(ref_worker.socket_path), "tpu")):
        (tmp_path / f"root-{name}").mkdir()
        code = client.build([
            "build", str(ctx), "-t", "worker/test:1", "--hasher", hasher,
            "--storage", str(tmp_path / f"storage-{name}"),
            "--root", str(tmp_path / f"root-{name}"),
            "--dest", str(tmp_path / f"out-{name}.tar")])
        assert code == 0
        assert (tmp_path / f"out-{name}.tar").exists()
        storage = tmp_path / f"storage-{name}"
        out[name] = (_kv_chunks(storage),
                     _manifest_layers(storage, "worker/test", "1"))
    assert out["port"] == out["ref"]
    assert any(chunks for chunks, _, _ in out["port"][0].values())
    assert service_mod._services["cpu"].passes >= 1


def test_build_failure_code(tmp_path, worker, ref_worker):
    for client in (WorkerClient(worker.socket_path),
                   RefClient(ref_worker.socket_path)):
        assert client.build(["build", "/nonexistent-ctx", "-t", "x:y",
                             "--storage", str(tmp_path / "s"),
                             "--root", str(tmp_path / "r")]) == 1


def test_prepare_context_copies_into_shared(tmp_path, worker):
    shared = tmp_path / "shared"
    shared.mkdir()
    ctx = tmp_path / "myctx"
    ctx.mkdir()
    (ctx / "f").write_text("x")
    client = WorkerClient(worker.socket_path,
                          local_shared_path=str(shared),
                          worker_shared_path="/mnt/shared")
    assert client.prepare_context(str(ctx)) == "/mnt/shared/myctx"
    assert (shared / "myctx" / "f").read_text() == "x"


def test_worker_cli_subcommand(tmp_path):
    """``python -m makisu_tpu_torch.cli worker --socket`` serves until
    ``/exit``, with rc 0 (the startup parity probe off: no card here)."""
    sock = str(tmp_path / "cliworker.sock")
    env = dict(os.environ, MAKISU_TPU_WORKER_WARM_PROBE="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "makisu_tpu_torch.cli", "worker",
         "--socket", sock, "--max-concurrent-builds", "2"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=ROOT,
        env=env)
    try:
        client = WorkerClient(sock)
        deadline = time.monotonic() + 60
        while not client.ready():
            assert time.monotonic() < deadline, "the worker never came up"
            time.sleep(0.1)
        assert client.healthz()["queue"]["max_concurrent_builds"] == 2
        client.exit()
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()


def test_worker_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """No fallback: a worker on the card probes S1 at startup, and on a
    host without CUDA it does not start."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is the card")
    monkeypatch.delenv("MAKISU_TPU_WORKER_WARM_PROBE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkerServer(str(tmp_path / "card.sock"))
    assert not (tmp_path / "card.sock").exists()
    rc = subprocess.run(
        [sys.executable, "-m", "makisu_tpu_torch.cli", "worker",
         "--socket", str(tmp_path / "card2.sock")], cwd=ROOT,
        capture_output=True, timeout=120).returncode
    assert rc == 1


def test_builds_sharing_root_serialize(tmp_path, worker):
    """Builds with the same --root must not interleave on the file
    system: the per-path locks serialise exactly those builds."""
    shared_root = tmp_path / "shared-root"
    shared_root.mkdir()
    results = {}

    def one(i):
        ctx = _ctx(tmp_path, f"sctx{i}",
                   "FROM scratch\n"
                   f"RUN echo {i} > who.txt && sleep 0.4 && "
                   f"test \"$(cat who.txt)\" = \"{i}\"\n", {})
        results[i] = WorkerClient(worker.socket_path).build([
            "build", str(ctx), "-t", f"w/s{i}:1",
            "--storage", str(tmp_path / f"ss{i}"),
            "--root", str(shared_root), "--modifyfs"])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == {0: 0, 1: 0}


def test_concurrent_build_log_streams_isolated(tmp_path, worker):
    """Each /build response streams only its own build's log lines."""
    lines = {0: [], 1: []}
    results = {}

    def one(i, dockerfile):
        ctx = _ctx(tmp_path, f"lctx{i}", dockerfile, {})
        (tmp_path / f"lroot{i}").mkdir()
        results[i] = WorkerClient(worker.socket_path).build([
            "build", str(ctx), "-t", f"w/log{i}:1",
            "--storage", str(tmp_path / f"ls{i}"),
            "--root", str(tmp_path / f"lroot{i}"), "--modifyfs"],
            on_line=lambda p, i=i: lines[i].append(p.get("msg", "")))

    threads = [
        threading.Thread(target=one, args=(
            0, "FROM scratch\nRUN echo MARKER-GOOD-BUILD\n"
               "RUN sleep 0.5\nRUN echo DONE-GOOD\n")),
        threading.Thread(target=one, args=(
            1, "FROM scratch\nRUN echo MARKER-BAD-BUILD\n"
               "RUN sleep 0.2 && echo FAILING-NOW && false\n")),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == {0: 0, 1: 1}
    good, bad = "\n".join(lines[0]), "\n".join(lines[1])
    assert "MARKER-GOOD-BUILD" in good
    assert "MARKER-BAD-BUILD" in bad and "FAILING-NOW" in bad
    assert "MARKER-BAD-BUILD" not in good and "FAILING-NOW" not in good
    assert "MARKER-GOOD-BUILD" not in bad


def test_concurrent_builds_run_in_parallel(tmp_path, worker):
    """Simultaneous builds run concurrently with isolated ARG/ENV, and
    their gpu-hasher commits share the service's launches."""
    results = {}

    def one(i):
        ctx = _ctx(tmp_path, f"ctx{i}",
                   "FROM scratch\n"
                   f"COPY f.txt /f{i}.txt\n"
                   f"ENV BUILD_VAL=value-{i}\n"
                   "RUN echo -n \"$BUILD_VAL\" > val.txt\n",
                   {"f.txt": str(i)})
        (tmp_path / f"root{i}").mkdir()
        results[i] = WorkerClient(worker.socket_path).build([
            "build", str(ctx), "-t", f"w/c{i}:1",
            "--storage", str(tmp_path / f"s{i}"),
            "--root", str(tmp_path / f"root{i}"), "--modifyfs",
            "--dest", str(tmp_path / f"out{i}.tar")])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == {0: 0, 1: 0, 2: 0}
    for i in range(3):
        assert _file_from_save_tar(str(tmp_path / f"out{i}.tar"),
                                   "val.txt") == f"value-{i}".encode()


def test_pull_through_worker_with_per_request_config(tmp_path, worker):
    """The worker serves pull too: a pull with its own --registry-config
    leaves the process-global config map untouched."""
    from makisu_tpu_torch.registry import make_test_image
    from makisu_tpu_torch.registry.client import set_transport_factory
    from makisu_tpu_torch.registry.config import _global_config
    from makisu_tpu_torch.registry.fixtures import RegistryFixture

    fixture = RegistryFixture()
    manifest, _config_blob, blobs = make_test_image()
    fixture.serve_image("team/app", "v1", manifest, blobs)
    set_transport_factory(lambda name: fixture)
    try:
        before = json.dumps(_global_config, default=str, sort_keys=True)
        cfg = tmp_path / "registry.yaml"
        cfg.write_text(json.dumps(
            {"registry.test": {"team/*": {"security": {
                "tls": {"client": {"disabled": True}}}}}}))
        code = WorkerClient(worker.socket_path).build([
            "--log-level", "error", "pull", "registry.test/team/app:v1",
            "--storage", str(tmp_path / "storage"),
            "--registry-config", str(cfg)])
        assert code == 0
        assert any(files for _, _, files in os.walk(
            tmp_path / "storage" / "layers"))
        assert json.dumps(_global_config, default=str,
                          sort_keys=True) == before
    finally:
        set_transport_factory(None)


def _frame_kinds(client_cls, sock, argv):
    """The frame kinds of a /build stream, read off the wire."""
    conn = http.client.HTTPConnection("localhost")
    s = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    s.connect(sock)
    conn.sock = s
    conn.request("POST", "/build", body=json.dumps(argv),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    kinds = []
    for line in resp.read().decode().splitlines():
        frame = json.loads(line)
        kinds.append("terminal" if "build_code" in frame else
                     "event" if "event" in frame else
                     "log" if set(frame) == {"level", "msg"} else
                     f"other:{sorted(frame)}")
    conn.close()
    return kinds, frame


def test_build_streams_event_frames(tmp_path, worker, ref_worker):
    """NDJSON framing: events ride the /build stream as their own frame
    kind and arrive as dicts in order; the port's stream has the
    reference's frame kinds and terminal keys."""
    ctx = _ctx(tmp_path, "ectx", "FROM scratch\nCOPY data.txt /data.txt\n",
               {"data.txt": "event frame payload"})
    (tmp_path / "eroot").mkdir()
    client = WorkerClient(worker.socket_path)
    streamed = []
    code = client.build([
        "--metrics-out", str(tmp_path / "ereport.json"),
        "build", str(ctx), "-t", "worker/events:1",
        "--storage", str(tmp_path / "estorage"),
        "--root", str(tmp_path / "eroot"),
        "--dest", str(tmp_path / "eout.tar")], on_event=streamed.append)
    assert code == 0
    report = json.loads((tmp_path / "ereport.json").read_text())
    [info] = report["gauges"]["makisu_build_info"]
    assert info["labels"]["mode"] == "worker"
    assert client.last_events == streamed
    types = [e["type"] for e in streamed]
    assert types[0] == "queue_wait"
    assert types[1] == "build_start"
    assert types[-1] == "build_end"
    assert "span_start" in types and "span_end" in types
    assert "step" in types
    assert all(isinstance(e["ts"], float) for e in streamed)
    opened = [e["span_id"] for e in streamed if e["type"] == "span_start"]
    closed = [e["span_id"] for e in streamed if e["type"] == "span_end"]
    assert sorted(opened) == sorted(closed)

    kinds = {}
    for name, sock in (("port", worker.socket_path),
                       ("ref", ref_worker.socket_path)):
        (tmp_path / f"kroot-{name}").mkdir()
        seq, terminal = _frame_kinds(None, sock, [
            "build", str(ctx), "-t", "worker/kinds:1",
            "--storage", str(tmp_path / f"kstorage-{name}"),
            "--root", str(tmp_path / f"kroot-{name}")])
        kinds[name] = (set(seq), seq[-1], sorted(terminal))
    assert kinds["port"] == kinds["ref"]
    assert kinds["port"][0] == {"log", "event", "terminal"}


def test_concurrent_builds_do_not_mix_event_streams(tmp_path, worker):
    streams = {}

    def one(i):
        ctx = _ctx(tmp_path, f"evctx{i}", "FROM scratch\nCOPY d.txt /d.txt\n",
                   {"d.txt": f"payload-{i}" * 8})
        (tmp_path / f"evroot{i}").mkdir()
        client = WorkerClient(worker.socket_path)
        events = []
        code = client.build([
            "build", str(ctx), "-t", f"worker/ev{i}:1",
            "--storage", str(tmp_path / f"evstorage{i}"),
            "--root", str(tmp_path / f"evroot{i}"),
            "--dest", str(tmp_path / f"evout{i}.tar")],
            on_event=events.append)
        streams[i] = (code, events)

    threads = [threading.Thread(target=one, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    trace_ids = {}
    for i in (0, 1):
        code, events = streams[i]
        assert code == 0 and events
        starts = [e for e in events if e["type"] == "build_start"]
        assert len(starts) == 1
        trace_ids[i] = starts[0]["trace_id"]
    assert trace_ids[0] != trace_ids[1]


def test_healthz(tmp_path, worker, ref_worker):
    client = WorkerClient(worker.socket_path)
    before = client.healthz()
    assert before["status"] == "ok"
    assert before["uptime_seconds"] >= 0
    assert before["active_builds"] == 0
    assert before["last_progress_seconds"] >= 0
    assert before["transfer_inflight_bytes"] >= 0
    assert before["transfer_queue_depth"] >= 0
    device = before["device"]
    assert device["probe"]["state"] in ("ok", "pending", "failed", "absent")
    assert "dispatch_seconds" in device
    assert device["h2d_bytes"] >= 0
    assert device["padding_waste_bytes"] >= 0
    assert before.device_probe_state == device["probe"]["state"]
    # The reference's keys, the storage plane's included.
    ref = RefClient(ref_worker.socket_path).healthz()
    assert set(before) == set(ref) - UNSERVED_HEALTH_KEYS
    for key in ("queue", "cache", "sessions", "alerts", "profiler",
                "storage"):
        assert set(before[key]) == set(ref[key]), key

    ctx = _ctx(tmp_path, "hctx", "FROM scratch\nCOPY h /h\n", {"h": "x"})
    (tmp_path / "hroot").mkdir()
    assert client.build(["build", str(ctx), "-t", "worker/h:1",
                         "--storage", str(tmp_path / "hstorage"),
                         "--root", str(tmp_path / "hroot"),
                         "--dest", str(tmp_path / "hout.tar")]) == 0
    assert client.build(["build", "/nonexistent", "-t", "x:y",
                         "--storage", str(tmp_path / "hs2"),
                         "--root", str(tmp_path / "hr2")]) == 1
    after = client.healthz()
    assert after["builds_started"] == before["builds_started"] + 2
    assert after["builds_succeeded"] == before["builds_succeeded"] + 1
    assert after["builds_failed"] == before["builds_failed"] + 1
    assert after["active_builds"] == 0
    assert after["uptime_seconds"] >= before["uptime_seconds"]
    assert after["last_progress_seconds"] < 30
    assert after["transfer_inflight_bytes"] == 0
    assert after["transfer_queue_depth"] == 0
    # The gpu build's ring pass went through the service: one dispatch.
    assert after["device"]["dispatch_seconds"]
    assert after.queue_wait.count == 2


def test_worker_process_recorder_captures_builds(tmp_path, worker):
    ctx = _ctx(tmp_path, "frctx", "FROM scratch\nCOPY f /f\n", {"f": "x"})
    (tmp_path / "frroot").mkdir()
    assert WorkerClient(worker.socket_path).build([
        "build", str(ctx), "-t", "worker/fr:1",
        "--storage", str(tmp_path / "frstorage"),
        "--root", str(tmp_path / "frroot")]) == 0
    bundle = worker.recorder.bundle("inspect")
    types = [e["type"] for e in bundle["events"]]
    assert "build_start" in types and "build_end" in types
    assert bundle["schema"] == "makisu-tpu.flightrecorder.v1"
    assert bundle["build"]["trace_id"] == \
        metrics.global_registry().trace_id


def test_worker_survives_systemexit_with_message(tmp_path, worker):
    bogus = tmp_path / "bogus.json"
    bogus.write_text('{"hello": "world"}')
    client = WorkerClient(worker.socket_path)
    lines = []
    assert client.build(["report", str(bogus)], on_line=lines.append) == 1
    assert any("not a makisu-tpu metrics report" in p.get("msg", "")
               for p in lines)
    assert client.ready()


# -- test_worker_queue.py ------------------------------------------------------


def test_admission_fifo_order():
    q = _AdmissionQueue(1)
    assert q.acquire() == 0.0
    order = []

    def waiter(i):
        q.acquire()
        order.append(i)
        time.sleep(0.02)
        q.release()

    threads = []
    for i in range(4):
        t = threading.Thread(target=waiter, args=(i,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 20
        while q.depth() < i + 1:
            assert time.monotonic() < deadline
            time.sleep(0.002)
    q.release()
    for t in threads:
        t.join(timeout=20)
    assert order == [0, 1, 2, 3]
    assert q.depth() == 0


def test_admission_unlimited_never_blocks():
    q = _AdmissionQueue(0)
    t0 = time.monotonic()
    for _ in range(100):
        assert q.acquire() == 0.0
    q.release()
    assert time.monotonic() - t0 < 5.0
    assert q.depth() == 0 and not q.would_block()


def test_admission_wait_is_measured():
    q = _AdmissionQueue(1)
    q.acquire()
    assert q.would_block()
    waited = {}

    def second():
        waited["s"] = q.acquire()
        q.release()

    t = threading.Thread(target=second)
    t.start()
    deadline = time.monotonic() + 20
    while q.depth() < 1:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    time.sleep(0.1)
    q.release()
    t.join(timeout=20)
    assert waited["s"] >= 0.1


def _queue_ctx(tmp_path, name):
    ctx = _ctx(tmp_path, name, "FROM scratch\nCOPY f /f\n",
               {"f": f"payload-{name}"})
    (tmp_path / f"{name}-root").mkdir()
    return ctx


def _queue_argv(tmp_path, ctx, name):
    return ["--log-level", "error", "build", str(ctx),
            "-t", f"queue/{name}:1",
            "--storage", str(tmp_path / f"{name}-storage"),
            "--root", str(tmp_path / f"{ctx.name}-root")]


def test_saturated_worker_queue_metrics(tmp_path, capped_worker):
    ctx = _queue_ctx(tmp_path, "qctx")
    capped_worker._admission.acquire()  # occupy the only slot
    client = WorkerClient(capped_worker.socket_path)
    done = {}

    def submit():
        done["code"] = client.build(_queue_argv(tmp_path, ctx, "queued"),
                                    tenant="acme")

    t = threading.Thread(target=submit)
    t.start()
    try:
        deadline = time.monotonic() + 30
        while capped_worker._admission.depth() < 1:
            assert time.monotonic() < deadline, \
                "the build never reached the admission queue"
            time.sleep(0.01)
        assert metrics.global_registry().gauge_value(
            "makisu_worker_queue_depth") == 1
        probe = WorkerClient(capped_worker.socket_path)
        builds = probe.builds()
        assert builds.queue_depth == 1
        assert builds.max_concurrent_builds == 1
        [queued] = builds.inflight
        assert queued.state == "queued"
        assert queued.tenant == "acme"
        assert queued.queue_wait_seconds > 0
        health = probe.healthz()
        assert health.queue_depth == 1
        assert health.max_concurrent_builds == 1
        assert health.active_builds == 0
    finally:
        capped_worker._admission.release()
        t.join(timeout=120)
    assert done["code"] == 0
    assert client.last_build["tenant"] == "acme"
    assert client.last_build["queue_wait_seconds"] > 0
    assert (client.last_build["elapsed_seconds"]
            >= client.last_build["queue_wait_seconds"])
    probe = WorkerClient(capped_worker.socket_path)
    health = probe.healthz()
    assert health.queue_depth == 0
    assert health.queue_wait.count == 1
    assert health.queue_wait.p50 > 0
    assert health.build_latency.count == 1
    assert health.build_latency.p50 >= health.queue_wait.p50
    assert health.tenant_latency["acme"].count == 1
    builds = probe.builds()
    assert builds.queue_depth == 0 and not builds.inflight
    [recent] = [b for b in builds.recent if b.tenant == "acme"]
    assert recent.state == "finished"
    assert recent.exit_code == 0
    assert recent.queue_wait_seconds > 0
    assert len(recent.trace_id) == 32
    text = probe.metrics()
    assert "makisu_build_queue_wait_seconds_bucket" in text
    assert 'tenant="acme"' in text
    assert 'makisu_build_latency_seconds_sum{tenant="acme"}' in text
    assert "makisu_worker_queue_depth 0" in text


def test_unsaturated_build_records_zero_wait(tmp_path, capped_worker):
    ctx = _queue_ctx(tmp_path, "fctx")
    client = WorkerClient(capped_worker.socket_path)
    assert client.build(_queue_argv(tmp_path, ctx, "fast")) == 0
    assert client.last_build["queue_wait_seconds"] == 0.0
    assert client.last_build["tenant"] == ""
    health = client.healthz()
    assert health.queue_wait.count == 1
    assert health.queue_wait.p50 == 0.0


def test_builds_record_phase_and_cache(tmp_path, capped_worker, ref_worker):
    """The /builds record is fed by the build's own events: trace id,
    phase and cache economics; its keys are the reference's."""
    ctx = _queue_ctx(tmp_path, "pctx")
    client = WorkerClient(capped_worker.socket_path)
    argv = _queue_argv(tmp_path, ctx, "phase") + ["--hasher", "gpu"]
    assert client.build(argv) == 0
    assert client.build(argv) == 0  # warm: a KV hit
    builds = WorkerClient(capped_worker.socket_path).builds()
    warm = builds.recent[0]  # newest first
    assert warm.phase
    cache = warm.get("cache", {})
    assert cache["kv_consults"] >= 1
    assert cache["kv_hits"] >= 1
    assert warm.cache_hit_ratio > 0
    ref_client = RefClient(ref_worker.socket_path)
    ref_argv = [a if a != str(tmp_path / "phase-storage") else
                str(tmp_path / "ref-phase-storage")
                for a in _queue_argv(tmp_path, ctx, "phase")]
    assert ref_client.build(ref_argv + ["--hasher", "tpu"]) == 0
    ref_builds = ref_client.builds()
    assert set(builds) == set(ref_builds)
    assert set(warm) == set(ref_builds["recent"][0])
    assert set(warm["cache"]) == set(ref_builds["recent"][0]["cache"])


def _unix_conn(path):
    class _Conn(http.client.HTTPConnection):
        def connect(self):
            sock = socket_mod.socket(socket_mod.AF_UNIX,
                                     socket_mod.SOCK_STREAM)
            sock.connect(path)
            self.sock = sock
    return _Conn("localhost")


def test_tenant_from_object_body(tmp_path, capped_worker):
    ctx = _queue_ctx(tmp_path, "octx")
    conn = _unix_conn(capped_worker.socket_path)
    conn.request("POST", "/build", body=json.dumps({
        "argv": _queue_argv(tmp_path, ctx, "objbody"),
        "tenant": "body-tenant"}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    payload = resp.read().decode()
    conn.close()
    assert '"exit_code": 0' in payload
    assert '"tenant": "body-tenant"' in payload
    recent = WorkerClient(capped_worker.socket_path).builds().recent
    assert recent[0].tenant == "body-tenant"


def test_bad_body_rejected(capped_worker):
    for body in ('{"argv": "not-a-list"}', '{"argv": [1, 2]}', '42'):
        conn = _unix_conn(capped_worker.socket_path)
        conn.request("POST", "/build", body=body,
                     headers={"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
    assert WorkerClient(capped_worker.socket_path).ready()


def test_no_wait_refused_when_saturated(tmp_path, capped_worker):
    capped_worker._admission.acquire()
    try:
        with pytest.raises(RuntimeError, match="503"):
            WorkerClient(capped_worker.socket_path).build(
                ["version"], no_wait=True)
    finally:
        capped_worker._admission.release()


def test_env_cap_configures_admission(tmp_path, monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_MAX_CONCURRENT_BUILDS", "3")
    server = WorkerServer(str(tmp_path / "env.sock"), device="cpu")
    try:
        assert server.max_concurrent_builds == 3
        assert server._admission.limit == 3
    finally:
        server.server_close()


def test_tenant_label_cardinality_capped(tmp_path):
    server = WorkerServer(str(tmp_path / "cap.sock"), device="cpu")
    try:
        for i in range(server_mod._TENANT_LABELS_KEEP + 10):
            record = server.register_build(["version"], f"tenant-{i}")
            record.start_running(0.0)
            server._retire_build(record, 0)
        rings = server._tenant_latency
        assert len(rings) == server_mod._TENANT_LABELS_KEEP + 1
        assert server_mod._TENANT_OVERFLOW in rings
        assert rings[server_mod._TENANT_OVERFLOW].stats()["count"] == 10
        assert server.builds()["recent"][0]["tenant"] == \
            f"tenant-{server_mod._TENANT_LABELS_KEEP + 9}"
        text = metrics.render_prometheus()
        assert f'tenant="{server_mod._TENANT_OVERFLOW}"' in text
    finally:
        server.server_close()


# -- sessions, snapshots, alerts ----------------------------------------------


@pytest.fixture
def fresh_sessions():
    session_mod.manager().reset()
    ref_session.manager().reset()
    yield
    session_mod.manager().reset()
    ref_session.manager().reset()


def test_worker_sessions_endpoint_and_invalidate(tmp_path, worker,
                                                 fresh_sessions):
    ctx = _ctx(tmp_path, "sctx", "FROM scratch\nCOPY a.txt /a.txt\n",
               {"a.txt": "alpha"})
    client = WorkerClient(worker.socket_path)
    argv = ["build", str(ctx), "-t", "w/s:1", "--hasher", "cpu",
            "--storage", str(tmp_path / "storage"),
            "--root", str(tmp_path / "root")]
    (tmp_path / "root").mkdir()
    assert client.build(argv) == 0
    sessions = client.sessions()
    assert sessions["count"] == 1
    assert sessions["sessions"][0]["context"] == str(ctx)
    health = client.healthz()
    assert health.sessions["count"] == 1
    assert isinstance(health.session_resident_bytes, int)
    assert client.build(argv[:3] + ["w/s:2"] + argv[4:]) == 0
    assert client.healthz().sessions["hits"] >= 1
    assert client.invalidate_sessions(str(ctx)) == 1
    assert client.sessions()["count"] == 0
    assert client.healthz().sessions["invalidations"].get("explicit") == 1
    # The server's own manager, not the process one.
    assert session_mod.manager().stats()["count"] == 0


def test_a_closed_worker_releases_its_sessions_watches(tmp_path,
                                                       fresh_sessions):
    """Inotify instances are a per-user budget (128 by default): a worker
    that closes drops its idle sessions and their watches at once, not
    when the collector finds it."""
    server = WorkerServer(str(tmp_path / "rel.sock"), device="cpu")
    thread = server.serve_background()
    ctx = _ctx(tmp_path, "rctx", "FROM scratch\nCOPY a.txt /a.txt\n",
               {"a.txt": "alpha"})
    (tmp_path / "root").mkdir()
    assert WorkerClient(server.socket_path).build([
        "--log-level", "error", "build", str(ctx), "-t", "w/rel:1",
        "--hasher", "cpu", "--storage", str(tmp_path / "storage"),
        "--root", str(tmp_path / "root")]) == 0
    [session] = server.session_mgr._sessions.values()
    watcher = session.watcher
    assert watcher is not None and watcher._fd >= 0
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)
    assert server.session_mgr.stats()["count"] == 0
    assert session.watcher is None and watcher._fd == -1


def test_worker_snapshot_endpoints(tmp_path, worker, fresh_sessions):
    ctx = _ctx(tmp_path, "snctx", "FROM scratch\nCOPY a.txt /a.txt\n",
               {"a.txt": "alpha"})
    (tmp_path / "root").mkdir()
    client = WorkerClient(worker.socket_path)
    assert client.build([
        "--log-level", "error", "build", str(ctx), "-t", "w/snap:1",
        "--hasher", "cpu", "--storage", str(tmp_path / "storage"),
        "--root", str(tmp_path / "root")]) == 0
    assert client.snapshot_sessions("")["snapshotted"] == 1
    recipe = client.session_snapshot(str(ctx))
    assert recipe["schema"] == snapshots_mod.SNAPSHOT_SCHEMA
    assert recipe["context"] == os.path.realpath(str(ctx))
    resp = client.restore_session({"context": str(ctx)})
    assert resp["ok"] is True
    bogus = client.restore_session({"context": str(tmp_path / "nope")})
    assert bogus["ok"] is False and bogus["reason"] == "no_snapshot"
    assert client.sessions()["snapshot"]["write"] >= 1
    # A recipe whose shard chunk is gone from the storage is refused.
    victim = recipe["shards"]["scan"]["chunk"]
    os.unlink(tmp_path / "storage" / "chunks" / victim[:2] / victim)
    resp = client.restore_session({"recipe": recipe})
    assert resp == {"ok": False, "reason": "chunks_unavailable"}
    assert client.sessions()["snapshot"]["restore_refused"] >= 1
    with pytest.raises(RuntimeError, match="404"):
        client.session_snapshot(str(tmp_path / "nope"))


def _cli(args, timeout=120):
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout


def test_sessions_and_alerts_subcommands_render_as_the_reference(
        tmp_path, worker, ref_worker, fresh_sessions):
    """``sessions SOCK`` and ``alerts SOCK`` of either package print the
    same text for the same payload; on an idle worker both packages'
    ``alerts`` say the same."""
    ctx = _ctx(tmp_path, "rctx", "FROM scratch\nCOPY a.txt /a.txt\n",
               {"a.txt": "alpha"})
    (tmp_path / "root").mkdir()
    assert WorkerClient(worker.socket_path).build([
        "build", str(ctx), "-t", "w/r:1", "--hasher", "cpu",
        "--storage", str(tmp_path / "storage"),
        "--root", str(tmp_path / "root")]) == 0
    for verb in (["sessions"], ["alerts"]):
        port = _cli(["makisu_tpu_torch.cli", *verb, worker.socket_path])
        ref = _cli(["makisu_tpu.cli", *verb, worker.socket_path])
        assert port[0] == ref[0] == 0
        assert port[1] == ref[1]
    assert "1 resident session(s)" in port[1] or "no active" in port[1]
    idle = [_cli([pkg, "alerts", sock])[1].replace(sock, "S")
            for pkg, sock in (("makisu_tpu_torch.cli", worker.socket_path),
                              ("makisu_tpu.cli", ref_worker.socket_path))]
    assert idle[0] == idle[1] and "no active alerts" in idle[0]
    rc, text = _cli(["makisu_tpu_torch.cli", "sessions",
                     worker.socket_path, "snapshot"])
    assert rc == 0 and text.startswith("checkpointed 1 session(s)")


def test_worker_alerts_payload_matches_reference(tmp_path, worker,
                                                 ref_worker):
    port = WorkerClient(worker.socket_path).alerts()
    ref = RefClient(ref_worker.socket_path).alerts()
    assert port == ref
    assert port["rules"] == [r.name for r in slo.default_worker_rules()]


def test_hash_linger_flag_sets_the_process_linger():
    from makisu_tpu_torch import cli
    from makisu_tpu_torch.utils import concurrency
    try:
        assert cli.main(["--hash-linger-ms", "5", "version"]) == 0
        assert concurrency.hash_linger_ms() == 5.0
    finally:
        concurrency.set_hash_linger_ms(None)


# -- test_slo.py, on both packages -----------------------------------------------


@pytest.fixture(params=["port", "reference"])
def pkg(request):
    """(slo module, alerts module) of one package."""
    return (slo, alerts_mod) if request.param == "port" else \
        (ref_slo, ref_alerts)


def test_window_delta_empty_and_single_sample_are_none(pkg):
    s, _ = pkg
    assert s.window_delta([], 60.0) is None
    assert s.window_delta([(0.0, 5.0)], 60.0) is None


def test_window_delta_uses_baseline_at_window_start(pkg):
    s, _ = pkg
    samples = [(0.0, 0.0), (30.0, 3.0), (60.0, 5.0), (90.0, 9.0)]
    assert s.window_delta(samples, 60.0, now=90.0) == 6.0


def test_window_delta_partial_window_falls_back_to_oldest(pkg):
    s, _ = pkg
    assert s.window_delta([(0.0, 1.0), (10.0, 4.0)], 3600.0,
                          now=10.0) == 3.0


def test_window_delta_counter_reset_clamps_to_zero(pkg):
    s, _ = pkg
    assert s.window_delta([(0.0, 100.0), (10.0, 2.0)], 60.0,
                          now=10.0) == 0.0


def test_burn_rate_none_when_denominator_flat(pkg):
    s, _ = pkg
    assert s.burn_rate([(0.0, 0.0), (10.0, 5.0)],
                       [(0.0, 7.0), (10.0, 7.0)], 60.0, now=10.0) is None


def test_burn_rate_ratio(pkg):
    s, _ = pkg
    assert s.burn_rate([(0.0, 0.0), (10.0, 1.0)],
                       [(0.0, 0.0), (10.0, 4.0)], 60.0, now=10.0) == 0.25


def _ramp(bad_per_tick, total_per_tick, ticks, step=1.0):
    num, den, b, t = [], [], 0.0, 0.0
    for i in range(ticks):
        b += bad_per_tick
        t += total_per_tick
        num.append((i * step, b))
        den.append((i * step, t))
    return num, den


def test_multi_window_breach_exact_threshold_fires(pkg):
    s, _ = pkg
    num, den = _ramp(1, 2, 10)
    breached, fast, slow = s.multi_window_breach(
        num, den, fast_window=3.0, slow_window=9.0, threshold=0.5, now=9.0)
    assert fast == 0.5 and slow == 0.5
    assert breached


def test_multi_window_breach_needs_both_windows(pkg):
    s, _ = pkg
    num = [(float(i), 0.0) for i in range(8)] + [(8.0, 1.0), (9.0, 2.0)]
    den = [(float(i), float(2 * i)) for i in range(10)]
    breached, fast, slow = s.multi_window_breach(
        num, den, fast_window=2.0, slow_window=9.0, threshold=0.5, now=9.0)
    assert fast is not None and fast >= 0.5
    assert slow is not None and slow < 0.5
    assert not breached


def test_multi_window_breach_no_data_is_not_an_outage(pkg):
    s, _ = pkg
    breached, fast, slow = s.multi_window_breach([], [], 300.0, 3600.0, 0.5)
    assert not breached and fast is None and slow is None


def test_rule_validation_rejects_bad_fields(pkg):
    s, _ = pkg
    with pytest.raises(ValueError):
        s.SloRule("r", "nope", signal="x")
    with pytest.raises(ValueError):
        s.SloRule("r", "level", signal="x", severity="critical")
    with pytest.raises(ValueError):
        s.SloRule("r", "level", signal="x", op="gt")
    with pytest.raises(ValueError):
        s.SloRule("r", "burn_rate", numerator="a")
    with pytest.raises(ValueError):
        s.SloRule("r", "level")


def test_rule_roundtrips_through_dict(pkg):
    s, _ = pkg
    rule = s.SloRule("burn", "burn_rate", severity="page", threshold=0.5,
                     numerator="bad", denominator="total", fast_window=30.0,
                     slow_window=600.0, message="m")
    again = s.SloRule.from_dict(rule.to_dict())
    assert again.to_dict() == rule.to_dict()
    assert again.fast_window == 30.0 and again.slow_window == 600.0


def test_load_rules_merges_disables_and_adds(pkg, tmp_path):
    s, _ = pkg
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": [
        {"name": "build_error_burn", "threshold": 0.9},
        {"name": "storage_budget", "disabled": True},
        {"name": "custom_queue", "kind": "level", "signal": "queue_depth",
         "threshold": 3.0},
    ]}))
    rules = {r.name: r for r in s.load_rules(str(path),
                                             s.default_worker_rules())}
    assert rules["build_error_burn"].threshold == 0.9
    assert rules["build_error_burn"].numerator == "builds_failed"
    assert "storage_budget" not in rules
    assert rules["custom_queue"].signal == "queue_depth"


def test_load_rules_rejects_malformed(pkg, tmp_path):
    s, _ = pkg
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"rules": [{"kind": "level"}]}))
    with pytest.raises(ValueError):
        s.load_rules(str(path))
    path.write_text(json.dumps({"rules": "nope"}))
    with pytest.raises(ValueError):
        s.load_rules(str(path))


def test_default_worker_rules_are_the_reference_and_valid(pkg):
    s, _ = pkg
    rules = s.default_worker_rules()
    for rule in rules:
        s.SloRule.from_dict(rule.to_dict())
    assert [r.to_dict() for r in rules] == \
        [r.to_dict() for r in ref_slo.default_worker_rules()]


def test_alert_fires_immediately_and_resolves_with_hysteresis(pkg):
    _, a = pkg
    mgr = a.AlertManager(resolve_after=2)
    assert mgr.observe("r", True, severity="page") == "fired"
    assert mgr.observe("r", True) is None
    assert mgr.observe("r", False) is None
    assert mgr.observe("r", False) == "resolved"
    assert mgr.active() == []
    assert mgr.recent()[0]["rule"] == "r"


def test_alert_flap_does_not_resolve(pkg):
    _, a = pkg
    mgr = a.AlertManager(resolve_after=2)
    mgr.observe("r", True)
    assert mgr.observe("r", False) is None
    assert mgr.observe("r", True) is None
    assert mgr.observe("r", False) is None
    assert mgr.observe("r", False) == "resolved"
    assert mgr.recent()[0]["fire_count"] == 1


def test_alert_clear_without_fire_creates_no_state(pkg):
    _, a = pkg
    mgr = a.AlertManager()
    assert mgr.observe("r", False) is None
    assert mgr.snapshot()["counts"]["active"] == 0
    assert mgr.digest() == {"active": 0, "page": 0, "warn": 0}


def test_alert_snapshot_counts_and_digest(pkg):
    _, a = pkg
    mgr = a.AlertManager()
    mgr.observe("p", True, severity="page", label="w0")
    mgr.observe("w", True, severity="warn")
    snap = mgr.snapshot()
    assert snap["counts"] == {"active": 2, "page": 1, "warn": 1}
    assert snap["active"][0]["rule"] == "p"
    assert snap["active"][0]["label"] == "w0"
    assert mgr.digest() == {"active": 2, "page": 1, "warn": 1}


def test_render_alerts_names_rules_and_labels(pkg, monkeypatch):
    _, a = pkg
    mgr = a.AlertManager()
    mgr.observe("burn", True, severity="page", label="w1", value=1.0,
                threshold=0.5, message="burning")
    # Both renders read the firing age at one instant: a wall clock that
    # steps back between them would print "-0s" in one of them.
    now = time.time() + 1.0
    monkeypatch.setattr(time, "time", lambda: now)
    text = a.render_alerts(mgr.snapshot(), heading="h")
    assert "burn[w1]" in text and "[page]" in text
    assert "value 1 vs threshold 0.5" in text
    assert "no active alerts" in a.render_alerts(a.AlertManager().snapshot())
    # The same payload renders the same text in both packages.
    assert text == ref_alerts.render_alerts(mgr.snapshot(), heading="h")


def test_evaluator_burn_rule_fires_per_label(pkg):
    s, _ = pkg
    probes = []
    rule = s.SloRule("burn", "burn_rate", severity="page", threshold=0.5,
                     numerator="bad", denominator="total",
                     fast_window=10.0, slow_window=30.0)
    ev = s.SloEvaluator(lambda: probes.pop(0), [rule], interval=0)
    for tick, (bad_w0, bad_w1, total) in enumerate(
            [(0, 0, 1), (1, 0, 2), (2, 0, 3)]):
        probes.append({"counters": {
            "bad": {"w0": float(bad_w0), "w1": float(bad_w1)},
            "total": {"w0": float(total), "w1": float(total)}}})
        ev.tick(now=float(tick))
    active = ev.manager.active()
    assert [x["label"] for x in active] == ["w0"]
    assert active[0]["rule"] == "burn"


def test_evaluator_level_rule_breach_for_hysteresis(pkg):
    s, _ = pkg
    levels = {"depth": 9.0}
    rule = s.SloRule("q", "level", signal="depth", threshold=5.0,
                     breach_for=2)
    ev = s.SloEvaluator(lambda: {"levels": levels}, [rule], interval=0)
    ev.tick(now=0.0)
    assert ev.manager.active() == []
    ev.tick(now=1.0)
    assert [x["rule"] for x in ev.manager.active()] == ["q"]
    ev2 = s.SloEvaluator(lambda: {"levels": levels}, [rule], interval=0)
    ev2.tick(now=0.0)
    levels["depth"] = 0.0
    ev2.tick(now=1.0)
    levels["depth"] = 9.0
    ev2.tick(now=2.0)
    assert ev2.manager.active() == []


def test_evaluator_le_rule_and_vanished_label_clears(pkg):
    s, a = pkg
    scores = {"canary_health_score": {"w0": 0.3}}
    rule = s.SloRule("health", "level", severity="page",
                     signal="canary_health_score", op="le", threshold=0.5)
    ev = s.SloEvaluator(lambda: {"levels": dict(scores)}, [rule],
                        manager=a.AlertManager(resolve_after=1), interval=0)
    ev.tick(now=0.0)
    assert [x["label"] for x in ev.manager.active()] == ["w0"]
    scores.clear()
    ev.tick(now=1.0)
    assert ev.manager.active() == []


def test_evaluator_probe_failure_never_raises(pkg):
    s, _ = pkg

    def probe():
        raise RuntimeError("probe died")

    ev = s.SloEvaluator(probe, s.default_worker_rules(), interval=0)
    ev.tick(now=0.0)
    assert ev.manager.active() == []


def test_worker_slo_probe_fires_error_burn(tmp_path, monkeypatch):
    """The worker's evaluator reads its own outcome counters: failing
    builds page ``build_error_burn`` on GET /alerts (a generous interval,
    deadlines of tens of seconds)."""
    server = WorkerServer(str(tmp_path / "slo.sock"), slo_interval=0.2,
                          device="cpu")
    thread = server.serve_background()
    try:
        server.slo.tick()  # the baseline sample, before any build
        client = WorkerClient(server.socket_path)
        for _ in range(3):
            assert client.build(["build", "/nonexistent", "-t", "x:y",
                                 "--storage", str(tmp_path / "s"),
                                 "--root", str(tmp_path / "r")]) == 1
        deadline = time.monotonic() + 20
        while not any(x["rule"] == "build_error_burn"
                      for x in client.alerts()["active"]):
            assert time.monotonic() < deadline, client.alerts()
            time.sleep(0.2)
        assert client.healthz()["alerts"]["page"] >= 1
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_history_aggregate_and_diff_alert_attribution(package):
    if package == "port":
        from makisu_tpu_torch.utils import history
    else:
        from makisu_tpu.utils import history
    base = [{"duration_seconds": 1.0, "exit_code": 0,
             "alerts_fired": 0} for _ in range(4)]
    cand = [{"duration_seconds": 1.0, "exit_code": 0,
             "alerts_fired": 2} for _ in range(4)]
    agg = history.aggregate(cand)
    assert agg["alerts_fired"] == 8 and agg["alert_rate"] == 2.0
    result = history.diff(base, cand)
    assert result["alert_rate_change"]["candidate_fired"] == 8
    assert result["ok"]  # attribution, not a regression verdict
    assert "ran under SLO alerts" in history.render_diff(result)
    old = [{"duration_seconds": 1.0, "exit_code": 0}] * 4
    assert "alert_rate_change" not in history.diff(old, old)


def test_a_wave_of_connections_is_accepted(worker):
    """64 clients connecting at once (a wave of build jobs) all get an
    answer: the listen backlog holds them."""
    barrier = threading.Barrier(64)
    answers = []

    def poll():
        barrier.wait(timeout=30)
        answers.append(WorkerClient(worker.socket_path,
                                    retries=0).healthz()["status"])

    threads = [threading.Thread(target=poll) for _ in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert answers == ["ok"] * 64
