"""The port's fleet front door (``makisu_tpu_torch/fleet/``) on the CPU,
held against the JAX package's.

The cases of ``tests/test_fleet.py``, the fleet cases of
``tests/test_slo.py`` and ``tests/test_trace_propagation.py`` and the
fleet doctor case of ``tests/test_census.py`` run on the port: its
scheduler and front door over port workers on ``device="cpu"`` (their
``--hasher gpu`` builds run the kernels' plain versions). Then the two
packages side by side: the same placement for 1,000 seeded context keys,
the same ``build_identity``, the same fleet rules, the same rendered
text of ``doctor --fleet``, ``top`` and ``report --fleet`` on the same
payloads, the reference's client building through the port's front door,
a wave of 64 simultaneous connects, and the front door and its readers
running without torch. Tolerance: none; digests, placement and text are
compared for equality.
"""

import contextvars
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from makisu_tpu import cli as ref_cli
from makisu_tpu.fleet import doctor as ref_doctor
from makisu_tpu.fleet import peers as ref_peers
from makisu_tpu.fleet import scheduler as ref_scheduler
from makisu_tpu.fleet import server as ref_server
from makisu_tpu.fleet import slo as ref_slo
from makisu_tpu.tools import top as ref_top
from makisu_tpu.utils import mountinfo as ref_mountinfo
from makisu_tpu.utils import traceexport as ref_traceexport
from makisu_tpu.worker import WorkerClient as RefWorkerClient
from makisu_tpu.worker import session as ref_session
from makisu_tpu_torch import cli
from makisu_tpu_torch.docker.image import ImageName
from makisu_tpu_torch.fleet import FleetServer, WorkerSpec
from makisu_tpu_torch.fleet import doctor as fleet_doctor
from makisu_tpu_torch.fleet import peers as fleet_peers
from makisu_tpu_torch.fleet import slo
from makisu_tpu_torch.fleet.kv import SharedKVServer
from makisu_tpu_torch.fleet.scheduler import FleetScheduler, build_identity
from makisu_tpu_torch.fleet.server import rewrite_storage
from makisu_tpu_torch.serve import server as serve_server
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.storage import ImageStore
from makisu_tpu_torch.tools import top
from makisu_tpu_torch.utils import history as history_mod
from makisu_tpu_torch.utils import metrics, mountinfo, traceexport
from makisu_tpu_torch.worker import WorkerClient, WorkerServer, session
from makisu_tpu_torch.worker.client import _UnixHTTPConnection

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    """Empty peer maps and serve registries in both packages, no host
    mount table, no one-second wait before a commit, and what a worker
    turns on for its process (MAKISU_TPU_SHARED_HASH, recipe publishing)
    restored after each test. Sessions track their contexts by mtime
    walks, not inotify: the tests' many workers would otherwise spend
    the per-user inotify budget (128) that every test process shares."""
    from makisu_tpu.serve import server as ref_serve_server
    from makisu_tpu.snapshot import memfs as ref_memfs
    monkeypatch.setenv("MAKISU_TPU_SESSION_MAX_WATCHES", "0")
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")
    for mod in (serve_server, ref_serve_server):
        monkeypatch.setattr(mod, "_publishing", mod._publishing)
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    monkeypatch.setattr(ref_memfs.MemFS, "_sync", lambda self: None)
    mountinfo.set_mountpoints_for_testing(set())
    ref_mountinfo.set_mountpoints_for_testing(set())
    for mod in (fleet_peers, ref_peers):
        mod.reset()
    for mod in (serve_server, ref_serve_server):
        mod.reset_stores()
    yield
    # The direct builds' resident sessions hold inotify instances, a
    # per-user budget every test process shares.
    session.manager().reset()
    ref_session.manager().reset()
    for mod in (fleet_peers, ref_peers):
        mod.reset()
    for mod in (serve_server, ref_serve_server):
        mod.reset_stores()
    mountinfo.set_mountpoints_for_testing(None)
    ref_mountinfo.set_mountpoints_for_testing(None)


def _make_ctx(tmp_path, name="ctx", files=4):
    """test_fleet.py's context: ``files`` small seeded sources."""
    rng = np.random.default_rng(abs(hash(name)) % (2 ** 32))
    ctx = tmp_path / name
    (ctx / "src").mkdir(parents=True)
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY src/ /src/\n")
    for i in range(files):
        (ctx / "src" / f"m{i}.py").write_text(
            f"# {name} {i} {int(rng.integers(1 << 30))}\n" + "x=1\n" * 120)
    (tmp_path / "root").mkdir(exist_ok=True)
    return ctx


def _build_argv(tmp_path, ctx, kv_addr="", hasher="gpu", extra=()):
    argv = ["--log-level", "error", "build", str(ctx),
            "-t", f"fleet/{ctx.name}:1", "--hasher", hasher,
            "--root", str(tmp_path / "root")]
    if kv_addr:
        argv += ["--http-cache-addr", kv_addr]
    return argv + list(extra)


def _digests(storage, tag):
    with ImageStore(str(storage)) as store:
        manifest = store.manifests.load(ImageName.parse(tag))
        return [layer.digest.hex() for layer in manifest.layers]


def _ref_build(tmp_path, ctx, tag, storage, extra=()):
    """The reference package's build of ``ctx`` (its cpu hasher: the
    digests do not depend on the hasher), in a context of its own as a
    process of its own would run it."""
    root = tmp_path / f"ref-root-{abs(hash(tag)) % 10 ** 8}"
    root.mkdir(exist_ok=True)
    return contextvars.copy_context().run(ref_cli.main, [
        "--log-level", "error", "build", str(ctx), "-t", tag,
        "--hasher", "cpu", "--storage", str(storage), "--root", str(root),
        *extra])


def _post_drain(socket_path, worker_id, undrain=False):
    conn = _UnixHTTPConnection(socket_path, 10.0)
    try:
        conn.request("POST", "/drain", body=json.dumps(
            {"worker": worker_id, "undrain": undrain}).encode())
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())
    finally:
        conn.close()


def _wait_state(client, worker_id, state, timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        workers = {w["id"]: w for w in client.healthz()["fleet"]["workers"]}
        if workers[worker_id]["state"] == state:
            return
        assert time.monotonic() < deadline, workers[worker_id]
        time.sleep(0.05)


class _Fleet:
    """N in-process port workers on the CPU (each with its own storage)
    behind the port's FleetServer, plus a shared KV."""

    def __init__(self, tmp_path, n=2, tenant_quota=0, poll_interval=0.2):
        self.kv = SharedKVServer()
        self.kv_addr = self.kv.start()
        self.workers = {}
        specs = []
        for i in range(n):
            wid = f"w{i}"
            server = WorkerServer(str(tmp_path / f"{wid}.sock"),
                                  device="cpu")
            server.serve_background()
            self.workers[wid] = server
            specs.append(WorkerSpec(wid, server.socket_path,
                                    str(tmp_path / f"{wid}-storage")))
        self.specs = {s.id: s for s in specs}
        self.server = FleetServer(str(tmp_path / "fleet.sock"), specs,
                                  poll_interval=poll_interval,
                                  tenant_quota=tenant_quota)
        self.server.serve_background()
        self.client = WorkerClient(self.server.socket_path)
        deadline = time.monotonic() + 30
        while not self.client.ready():
            assert time.monotonic() < deadline, "fleet never ready"
            time.sleep(0.05)

    def drain(self, worker_id, undrain=False):
        _post_drain(self.server.socket_path, worker_id, undrain)
        _wait_state(self.client, worker_id,
                    "alive" if undrain else "draining")

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        for server in self.workers.values():
            server.shutdown()
            server.server_close()
        self.kv.stop()


@pytest.fixture
def fleet2(tmp_path):
    fleet = _Fleet(tmp_path, n=2)
    yield fleet
    fleet.close()


def _sched(n=3):
    specs = [WorkerSpec(f"w{i}", f"/tmp/w{i}.sock") for i in range(n)]
    sched = FleetScheduler(specs)
    for state in sched.workers.values():
        state.alive = True
    return sched


# -- units (tests/test_fleet.py) ---------------------------------------------


def test_rewrite_storage_forms():
    for argv, want in (
            (["build", "c", "--storage", "/a"],
             ["build", "c", "--storage", "/b"]),
            (["build", "c", "--storage=/a"], ["build", "c", "--storage=/b"]),
            (["build", "c"], ["build", "c", "--storage", "/b"])):
        assert rewrite_storage(argv, "/b") == want
        assert ref_server.rewrite_storage(argv, "/b") == want


def test_build_identity_resolves_context(tmp_path):
    ctx = tmp_path / "ident-ctx"
    ctx.mkdir()
    key, command = build_identity(
        ["--log-level", "error", "build", str(ctx), "-t", "a/b:1"])
    assert command == "build"
    assert key == os.path.realpath(str(ctx))
    key, command = build_identity(["pull", "busybox"])
    assert command == "pull" and key == ""


def test_client_unreachable_worker_fails_promptly(tmp_path):
    client = WorkerClient(str(tmp_path / "nope.sock"),
                          connect_timeout=0.5, retries=2)
    t0 = time.monotonic()
    assert client.ready() is False
    with pytest.raises(OSError):
        client.healthz()
    assert time.monotonic() - t0 < 5.0


def test_consistent_hash_placement_is_stable():
    sched = _sched()
    first = {}
    for key in ("ctx-a", "ctx-b", "ctx-c", "ctx-d"):
        worker, verdict, _ = sched.route(key)
        first[key] = worker.spec.id
        assert verdict == "spillover"
    for key, wid in first.items():
        worker, verdict, _ = sched.route(key)
        assert worker.spec.id == wid
        assert verdict == "affinity"


def test_scheduler_quota_blocks_and_records():
    sched = FleetScheduler([WorkerSpec("w0", "/tmp/w0.sock")],
                           tenant_quota=1)
    sched.workers["w0"].alive = True
    assert sched.admit("team-a") < 0.05
    waited = []
    t = threading.Thread(target=lambda: waited.append(sched.admit("team-a")))
    t.start()
    deadline = time.monotonic() + 5
    while sched.frontdoor_waiting() < 1:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert sched.stats()["route_totals"].get("quota_denied", 0) >= 1
    sched.release("team-a")
    t.join(timeout=5)
    assert waited and waited[0] > 0
    sched.release("team-a")
    assert sched.frontdoor_waiting() == 0
    assert sched.admit("team-b") < 0.05
    sched.release("team-b")


def test_quota_admission_is_fifo():
    sched = FleetScheduler([WorkerSpec("w0", "/tmp/w0.sock")],
                           tenant_quota=1)
    sched.workers["w0"].alive = True
    sched.admit("t")
    gate = sched._tenant_budget("t")
    order = []

    def waiter(i):
        sched.admit("t")
        order.append(i)
        time.sleep(0.01)
        sched.release("t")

    threads = []
    for i in range(3):
        t = threading.Thread(target=waiter, args=(i,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 5
        while len(gate._waiters) < i + 1:
            assert time.monotonic() < deadline
            time.sleep(0.002)
    sched.release("t")
    for t in threads:
        t.join(timeout=10)
    assert order == [0, 1, 2]
    assert gate.inflight == 0


def test_eligible_count_ignores_dead_and_draining():
    specs = [WorkerSpec(f"w{i}", f"/tmp/w{i}.sock") for i in range(3)]
    sched = FleetScheduler(specs)
    sched.workers["w0"].alive = True
    sched.workers["w1"].alive = True
    sched.workers["w1"].draining = True
    assert sched.eligible_count() == 1
    assert sched.eligible_count(exclude={"w0"}) == 0


def test_peer_map_version_adopted_after_restart(tmp_path):
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    thread = server.serve_background()
    try:
        fleet_peers.set_peers(["/tmp/stale-old-worker.sock"], 7)
        sched = FleetScheduler([WorkerSpec("w0", server.socket_path)],
                               poll_interval=60)
        sched.poll_once()  # publish v1, refused: adopts v8
        assert sched._peer_version >= 8
        sched.poll_once()  # the adopted version is applied
        assert fleet_peers.peers() == (server.socket_path,)
        assert fleet_peers.map_version() >= 8
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def test_tenant_label_cardinality_cap():
    sched = FleetScheduler([WorkerSpec("w0", "/tmp/w0.sock")],
                           tenant_quota=1)
    for i in range(64):
        assert sched.tenant_label(f"t{i}") == f"t{i}"
    assert sched.tenant_label("t-overflow") == "other"
    assert sched.tenant_label("t3") == "t3"
    assert sched._tenant_budget("another-new").limit == 1


def test_worker_chunk_endpoint_validates_and_serves(tmp_path):
    import hashlib

    from makisu_tpu_torch.cache import chunks as chunks_mod
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    thread = server.serve_background()
    try:
        store = chunks_mod.ChunkStore(str(tmp_path / "chunk-cas"))
        chunks_mod.register_serving_store(store)
        data = b"peer exchange payload"
        hex_digest = hashlib.sha256(data).hexdigest()
        store.put(hex_digest, data)

        def get(path):
            conn = _UnixHTTPConnection(server.socket_path, 10.0)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        # A store the server does not own is not served.
        assert get(f"/chunks/{hex_digest}")[0] == 404
        server.add_served_chunk_root(str(tmp_path / "chunk-cas"))
        assert get(f"/chunks/{hex_digest}") == (200, data)
        assert get("/chunks/" + "0" * 64)[0] == 404
        assert get("/chunks/../../etc/passwd")[0] == 400
        assert get("/chunks/ABCD")[0] == 400
    finally:
        with chunks_mod._serving_lock:
            chunks_mod._serving_stores.pop(
                os.path.realpath(store.cas.root), None)
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def test_no_wait_admission_refusal(tmp_path):
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu",
                          max_concurrent_builds=1)
    thread = server.serve_background()
    try:
        server._admission.acquire()  # saturate the only slot
        conn = _UnixHTTPConnection(server.socket_path, 10.0)
        try:
            conn.request("POST", "/build",
                         body=json.dumps(["version"]).encode(),
                         headers={"Content-Type": "application/json",
                                  "X-Makisu-No-Wait": "1"})
            resp = conn.getresponse()
            assert resp.status == 503
            assert json.loads(resp.read())["error"] == "admission_refused"
        finally:
            conn.close()
        server._admission.release()
        assert WorkerClient(server.socket_path).build(["version"]) == 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def test_healthz_reads_a_half_imported_backend_as_absent(tmp_path,
                                                         monkeypatch):
    """A poll that lands while a first build is still importing the
    device plane (torch) on another thread reads it as absent, not as a
    failed /healthz that would make the front door take the worker for
    dead."""
    import types
    half = types.ModuleType("makisu_tpu_torch.ops.backend")
    half.__spec__ = types.SimpleNamespace(_initializing=True)
    monkeypatch.setitem(sys.modules, "makisu_tpu_torch.ops.backend", half)
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    thread = server.serve_background()
    try:
        health = WorkerClient(server.socket_path).healthz()
        assert health["device"]["probe"]["state"] == "absent"
        sched = FleetScheduler([WorkerSpec("w0", server.socket_path)],
                               poll_interval=60)
        sched.poll_once()
        assert sched.workers["w0"].alive
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


# -- routing end to end ------------------------------------------------------


def test_affinity_routes_to_session_holder(tmp_path, fleet2):
    """Twice through the front door: the second build lands on the
    session holder as an affinity verdict and hits its session; the
    terminal frame carries the four routing fields; the layers equal a
    direct port build's and the reference package's."""
    ctx = _make_ctx(tmp_path)
    argv = _build_argv(tmp_path, ctx, fleet2.kv_addr)
    assert fleet2.client.build(argv, tenant="team-a") == 0
    first = dict(fleet2.client.last_build)
    assert first["worker"] in fleet2.workers
    assert first["fleet_verdict"] == "spillover"
    assert first["fleet_attempts"] == 1
    assert first["quota_wait_seconds"] == 0.0
    assert fleet2.client.build(argv, tenant="team-a") == 0
    second = dict(fleet2.client.last_build)
    assert second["worker"] == first["worker"]
    assert second["fleet_verdict"] == "affinity"
    holder = fleet2.workers[first["worker"]]
    sessions = holder.session_mgr.stats()
    assert sessions["count"] == 1 and sessions["hits"] >= 1
    for wid, server in fleet2.workers.items():
        if wid != first["worker"]:
            assert server.session_mgr.stats()["count"] == 0
    health = fleet2.client.healthz()
    assert health["fleet"]["route_totals"].get("affinity", 0) >= 1
    # The owner is the ring's: the port scheduler and the reference's
    # place this context on the same worker.
    key = os.path.realpath(str(ctx))
    ring = ref_scheduler.FleetScheduler._build_ring(["w0", "w1"])
    sched = ref_scheduler.FleetScheduler(
        [ref_scheduler.WorkerSpec(w, "/x") for w in ("w0", "w1")])
    sched._ring = ring
    assert sched._ring_owner(key, {"w0", "w1"}) == first["worker"]
    got = _digests(fleet2.specs[first["worker"]].storage, f"fleet/{ctx.name}:1")
    worker = WorkerServer(str(tmp_path / "direct.sock"), device="cpu")
    worker.serve_background()
    try:
        (tmp_path / "root-direct").mkdir()
        assert WorkerClient(worker.socket_path).build(
            ["--log-level", "error", "build", str(ctx), "-t", "direct/c:1",
             "--hasher", "gpu", "--storage", str(tmp_path / "direct"),
             "--root", str(tmp_path / "root-direct")]) == 0
    finally:
        worker.shutdown()
        worker.server_close()
    assert _digests(tmp_path / "direct", "direct/c:1") == got
    assert _ref_build(tmp_path, ctx, "ref/c:1", tmp_path / "ref") == 0
    assert _digests(tmp_path / "ref", "ref/c:1") == got


def _serve_total(g):
    return (g.counter_total("makisu_fleet_chunk_serves_total", result="hit")
            + sum(g.counter_total(metrics.SERVE_PACK_REQUESTS, kind=k)
                  for k in ("range", "full", "zrange", "zfull")))


def test_peer_chunk_fetch_hits_before_registry(tmp_path, fleet2):
    """Drain the session holder: the relocated build hits the shared
    KV, lacks every chunk, and fetches them worker to worker (no
    registry exists); the drain checkpoints the holder's sessions."""
    g = metrics.global_registry()
    before_hits = g.counter_total("makisu_fleet_peer_chunk_hits_total")
    before_serves = _serve_total(g)
    ctx = _make_ctx(tmp_path, "peer-ctx")
    argv = _build_argv(tmp_path, ctx, fleet2.kv_addr)
    assert fleet2.client.build(argv, tenant="t") == 0
    holder = fleet2.client.last_build["worker"]
    answer = _post_drain(fleet2.server.socket_path, holder)
    assert answer["draining"] and answer["sessions_snapshotted"] >= 0
    _wait_state(fleet2.client, holder, "draining")
    assert fleet2.client.build(argv, tenant="t") == 0
    second = dict(fleet2.client.last_build)
    assert second["worker"] != holder
    assert second["fleet_verdict"] == "spillover"
    assert g.counter_total("makisu_fleet_peer_chunk_hits_total") \
        > before_hits, "no chunk came from a peer"
    assert _serve_total(g) > before_serves, "no worker served a peer fetch"
    tag = f"fleet/{ctx.name}:1"
    assert _digests(fleet2.specs[holder].storage, tag) \
        == _digests(fleet2.specs[second["worker"]].storage, tag)


def test_worker_death_mid_build_fails_over(tmp_path):
    """SIGKILL a subprocess port worker while it is mid-build: the front
    door fails the build over to the survivor, and the digests equal a
    direct build's and the reference package's."""
    ctx = _make_ctx(tmp_path, "failover-ctx")
    # The RUN step keeps the build on the victim long enough to kill it.
    (ctx / "Dockerfile").write_text(
        "FROM scratch\nCOPY src/ /src/\nRUN sleep 3\n")
    victim_sock = str(tmp_path / "victim.sock")
    env = dict(os.environ, MAKISU_TPU_WORKER_WARM_PROBE="0")
    victim = subprocess.Popen(
        [sys.executable, "-m", "makisu_tpu_torch.cli", "worker",
         "--socket", victim_sock],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    survivor = WorkerServer(str(tmp_path / "survivor.sock"), device="cpu")
    survivor.serve_background()
    kv = SharedKVServer()
    kv_addr = kv.start()
    fleet = FleetServer(str(tmp_path / "fleet.sock"), [
        WorkerSpec("victim", victim_sock, str(tmp_path / "victim-storage")),
        WorkerSpec("survivor", survivor.socket_path,
                   str(tmp_path / "survivor-storage"))], poll_interval=0.2)
    fleet.serve_background()
    client = WorkerClient(fleet.socket_path)
    box = {}
    try:
        deadline = time.monotonic() + 60
        while True:
            if client.ready():
                workers = {w["id"]: w
                           for w in client.healthz()["fleet"]["workers"]}
                if all(w["alive"] for w in workers.values()):
                    break
            assert time.monotonic() < deadline, "workers never ready"
            time.sleep(0.1)
        _post_drain(fleet.socket_path, "survivor")  # route to the victim
        argv = ["--log-level", "error", "build", str(ctx),
                "-t", "fleet/failover:1", "--hasher", "cpu", "--modifyfs",
                "--root", str(tmp_path / "root"), "--http-cache-addr",
                kv_addr]

        def submit():
            box["code"] = client.build(argv, tenant="t")
            box["terminal"] = dict(client.last_build)

        submitter = threading.Thread(target=submit)
        submitter.start()
        victim_client = WorkerClient(victim_sock)
        deadline = time.monotonic() + 30
        while True:
            try:
                rows = victim_client.builds().inflight
            except (OSError, RuntimeError):
                rows = []
            if any(r.state == "running" for r in rows):
                break
            assert time.monotonic() < deadline, "never ran on the victim"
            time.sleep(0.05)
        _post_drain(fleet.socket_path, "survivor", undrain=True)
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=10)
        submitter.join(timeout=120)
        assert not submitter.is_alive(), "failover never completed"
        assert box["code"] == 0, box
        terminal = box["terminal"]
        assert terminal["worker"] == "survivor"
        assert terminal["fleet_verdict"] == "failover"
        assert terminal["fleet_attempts"] >= 2
        got = _digests(tmp_path / "survivor-storage", "fleet/failover:1")
        (tmp_path / "root2").mkdir()
        oracle = WorkerServer(str(tmp_path / "oracle.sock"), device="cpu")
        oracle.serve_background()
        try:
            assert WorkerClient(oracle.socket_path).build(
                ["--log-level", "error", "build", str(ctx), "-t",
                 "fleet/failover:oracle", "--hasher", "cpu", "--modifyfs",
                 "--root", str(tmp_path / "root2"), "--storage",
                 str(tmp_path / "oracle-storage")]) == 0
        finally:
            oracle.shutdown()
            oracle.server_close()
        assert _digests(tmp_path / "oracle-storage",
                        "fleet/failover:oracle") == got
        assert _ref_build(tmp_path, ctx, "ref/failover:1",
                          tmp_path / "ref", extra=["--modifyfs"]) == 0
        assert _digests(tmp_path / "ref", "ref/failover:1") == got
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.wait(timeout=10)
        fleet.shutdown()
        fleet.server_close()
        survivor.shutdown()
        survivor.server_close()
        kv.stop()


def test_tenant_quota_fifo_through_the_front_door(tmp_path):
    """Three builds of one tenant under a quota of 1: two wait at the
    front door (quota_denied decisions, a nonzero quota wait in their
    terminal frames) and all three succeed."""
    fleet = _Fleet(tmp_path, n=2, tenant_quota=1)
    try:
        ctxs = [_make_ctx(tmp_path, f"q{i}") for i in range(3)]
        frames = {}

        def submit(i):
            c = WorkerClient(fleet.server.socket_path)
            (tmp_path / f"root{i}").mkdir()
            code = c.build(["--log-level", "error", "build", str(ctxs[i]),
                            "-t", f"q/c{i}:1", "--hasher", "gpu", "--root",
                            str(tmp_path / f"root{i}")], tenant="solo")
            frames[i] = (code, dict(c.last_build))

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert sorted(frames) == [0, 1, 2]
        assert all(code == 0 for code, _ in frames.values())
        waits = sorted(f["quota_wait_seconds"] for _, f in frames.values())
        assert waits[0] == 0.0 and waits[-1] > 0
        decisions = fleet.client.healthz()["fleet"]["recent_decisions"]
        assert len([d for d in decisions
                    if d["verdict"] == "quota_denied"]) >= 1
    finally:
        fleet.close()


# -- health-demoted routing and the doctor (tests/test_slo.py) -------------


def test_evaluator_probe_failure_never_raises():
    def probe():
        raise RuntimeError("probe died")

    ev = slo.SloEvaluator(probe, slo.default_fleet_rules(), interval=0)
    ev.tick(now=0.0)
    assert ev.manager.active() == []


def test_route_demotes_unhealthy_worker():
    sched = _sched()
    sched.set_health_score("w1", 0.2)
    for key in ("ctx-a", "ctx-b", "ctx-c", "ctx-d", "ctx-e"):
        worker, _verdict, _ = sched.route(key)
        assert worker.spec.id != "w1"
    assert sched.stats()["route_totals"].get("health_demoted", 0) >= 1
    demoted = [d for d in sched.stats()["recent_decisions"]
               if d.get("verdict") == "health_demoted"]
    assert demoted and demoted[0]["worker"] == "w1"
    assert demoted[0]["reason"] == "canary_health"


def test_route_affinity_beats_health_demotion():
    sched = _sched()
    worker, _, _ = sched.route("ctx-sticky")
    holder = worker.spec.id
    sched.workers[holder].sessions = {"ctx-sticky"}
    sched.set_health_score(holder, 0.0)
    again, verdict, _ = sched.route("ctx-sticky")
    assert again.spec.id == holder and verdict == "affinity"


def test_route_all_unhealthy_still_routes():
    sched = _sched()
    for wid in list(sched.workers):
        sched.set_health_score(wid, 0.1)
    worker, _, _ = sched.route("ctx-any")
    assert worker is not None
    assert not [d for d in sched.stats()["recent_decisions"]
                if d.get("verdict") == "health_demoted"]


def test_route_pressure_demotes_full_worker():
    sched = _sched()
    sched.workers["w2"].storage = {"budget": {"pressure": 2.0}}
    for key in ("p-a", "p-b", "p-c", "p-d", "p-e", "p-f"):
        worker, _, _ = sched.route(key)
        assert worker.spec.id != "w2"
    demoted = [d for d in sched.stats()["recent_decisions"]
               if d.get("verdict") == "pressure_demoted"]
    assert demoted and demoted[0]["worker"] == "w2"


def test_health_score_clamped_and_snapshotted():
    sched = _sched(1)
    sched.set_health_score("w0", 7.5)
    assert sched.health_scores()["w0"] == 1.0
    sched.set_health_score("w0", -3.0)
    assert sched.stats()["workers"][0]["health_score"] == 0.0


def test_doctor_alert_findings_map_severities():
    snap = {
        "active": [{"rule": "fleet_error_burn", "severity": "page",
                    "value": 1.0, "threshold": 0.5, "message": "burning"}],
        "workers": {"w0": {"active": [
            {"rule": "queue_wait_share", "severity": "warn",
             "label": "tenant-a", "message": "queueing"}]}},
    }
    findings = fleet_doctor.alert_findings(snap)
    assert findings[0]["severity"] == "error"
    assert findings[0]["kind"] == "alert"
    worker_tagged = [f for f in findings if f["worker"] == "w0"]
    assert worker_tagged and worker_tagged[0]["severity"] == "warning"
    assert "queue_wait_share[tenant-a]" in worker_tagged[0]["detail"]
    assert fleet_doctor.alert_findings(None) == []
    assert findings == ref_doctor.alert_findings(snap)


def test_doctor_fleet_uses_healthz_digest_without_alerts():
    health = {"fleet": {"workers": [
        {"id": "w0", "alive": True,
         "alerts": {"active": 2, "page": 1, "warn": 1}},
        {"id": "w1", "alive": True, "alerts": {"active": 0}},
    ]}}
    rows = [f for f in fleet_doctor.diagnose_fleet(health)
            if f["kind"] == "alert"]
    assert len(rows) == 1 and rows[0]["worker"] == "w0"
    assert rows[0]["severity"] == "error"
    alerts = {"active": [{"rule": "r", "severity": "info", "message": "m"}]}
    rows = [f for f in fleet_doctor.diagnose_fleet(health, alerts=alerts)
            if f["kind"] == "alert"]
    assert len(rows) == 1 and rows[0]["rule"] == "r"


def test_top_fleet_lines_show_alerts_column():
    fleet = {"workers": [
        {"id": "w0", "state": "alive", "active_builds": 0,
         "queue_depth": 0, "sessions": [], "routed_total": 1,
         "socket": "/tmp/w0.sock", "health_score": 0.36,
         "alerts": {"active": 2, "page": 1, "warn": 1}},
        {"id": "w1", "state": "alive", "active_builds": 0,
         "queue_depth": 0, "sessions": [], "routed_total": 1,
         "socket": "/tmp/w1.sock", "health_score": 1.0, "alerts": {}},
    ]}
    lines = top._fleet_lines(fleet)
    header = next(line for line in lines if "WORKER" in line)
    assert "ALERTS" in header and "HEALTH" in header
    w0 = next(line for line in lines if line.startswith("w0"))
    assert "2!" in w0 and "0.36" in w0
    w1 = next(line for line in lines if line.startswith("w1"))
    assert " - " in w1 and "1.00" in w1
    assert lines == ref_top._fleet_lines(fleet)


def test_fleet_doctor_flags_storage():
    health = {"fleet": {"workers": [{
        "id": "w0", "alive": True, "state": "alive",
        "storage": {"total_bytes": 10,
                    "findings": {"total": 3,
                                 "kinds": {"dangling_chunk": 3}},
                    "lru_seed": {"state": "seeding",
                                 "seeded_entries": 1}}}]},
        "self": {}}
    kinds = {f["kind"] for f in fleet_doctor.diagnose_fleet(health)}
    assert {"storage_findings", "storage_unseeded"} <= kinds
    rendered = fleet_doctor.render_fleet_doctor(health, "sock")
    assert "STORAGE" in rendered
    assert rendered == ref_doctor.render_fleet_doctor(health, "sock")


# -- the two packages side by side -----------------------------------------


@pytest.mark.parametrize("n_workers", [2, 3, 4, 5])
def test_ring_places_like_the_reference(n_workers):
    """1,000 seeded context keys land on the reference's owner, with
    every worker eligible and with the first one out (the clockwise
    walk past an ineligible owner)."""
    rng = np.random.default_rng(1000 + n_workers)
    ids = [f"w{i}" for i in range(n_workers)]
    port = FleetScheduler([WorkerSpec(w, f"/tmp/{w}.sock") for w in ids])
    ref = ref_scheduler.FleetScheduler(
        [ref_scheduler.WorkerSpec(w, f"/tmp/{w}.sock") for w in ids])
    assert port._ring == ref._ring
    keys = ["/ctx/" + rng.bytes(12).hex() for _ in range(1000)]
    for eligible in (set(ids), set(ids[1:])):
        owners = [port._ring_owner(k, eligible) for k in keys]
        assert owners == [ref._ring_owner(k, eligible) for k in keys]
        assert set(owners) == eligible


@pytest.mark.parametrize("argv", [
    ["build", "CTX", "-t", "a/b:1"],
    ["--log-level", "error", "build", "CTX", "-t", "a/b:1"],
    ["--log-level=error", "build", "--tag=a/b:1", "CTX"],
    ["--log-lev", "error", "build", "CTX", "--modifyf", "-t", "x:1"],
    ["build", "--storage=/s", "--root", "/r", "CTX", "-t", "x:1"],
    ["pull", "busybox"],
    ["version"],
    ["--no-such-flag"],
])
def test_build_identity_matches_the_reference(tmp_path, argv):
    ctx = tmp_path / "id-ctx"
    ctx.mkdir()
    argv = [str(ctx) if a == "CTX" else a for a in argv]
    assert build_identity(argv) == ref_scheduler.build_identity(argv)


def test_default_fleet_rules_match_the_reference():
    assert [r.to_dict() for r in slo.default_fleet_rules()] \
        == [r.to_dict() for r in ref_slo.default_fleet_rules()]
    assert (slo.HEALTH_ALPHA, slo.HEALTH_PAGE_THRESHOLD) \
        == (ref_slo.HEALTH_ALPHA, ref_slo.HEALTH_PAGE_THRESHOLD)
    import inspect
    params = inspect.signature(slo.CanaryDriver).parameters
    assert params["hasher"].default == "gpu"
    assert inspect.signature(ref_slo.CanaryDriver).parameters[
        "hasher"].default == "cpu"


_CANNED_HEALTH = {
    "status": "ok", "uptime_seconds": 10.0, "active_builds": 1,
    "builds_succeeded": 4, "builds_failed": 1,
    "last_progress_seconds": 0.5,
    "queue": {"depth": 3, "max_concurrent_builds": 0,
              "wait_seconds": {}, "latency_seconds": {"count": 5,
                                                      "p50": 1.5,
                                                      "p99": 4.0}},
    "fleet": {
        "workers": [
            {"id": "w0", "alive": True, "draining": False,
             "state": "alive", "sessions": ["/ctx/a"],
             "active_builds": 1, "queue_depth": 0,
             "last_poll_age_seconds": 0.2, "routed_total": 5,
             "consecutive_failures": 0, "last_error": "",
             "socket": "/run/w0.sock", "health_score": 1.0,
             "alerts": {"active": 1, "page": 0, "warn": 1},
             "storage": {"total_bytes": 3 << 20,
                         "findings": {"total": 0}}},
            {"id": "w1", "alive": False, "draining": False,
             "state": "dead", "sessions": [], "active_builds": 0,
             "queue_depth": 0, "last_poll_age_seconds": 4.0,
             "routed_total": 2, "consecutive_failures": 7,
             "last_error": "connection refused", "socket": "/run/w1.sock"},
            {"id": "w2", "alive": True, "draining": True,
             "state": "draining", "sessions": [], "active_builds": 2,
             "queue_depth": 0, "last_poll_age_seconds": 0.2,
             "routed_total": 1, "consecutive_failures": 0,
             "last_error": "", "socket": "/run/w2.sock",
             "health_score": 0.36,
             "profiler": {"enabled": True, "overhead_fraction": 0.2}},
        ],
        "tenant_quota": 2,
        "tenants": {"team-a": {"inflight": 2, "quota": 2}},
        "frontdoor_waiting": 3,
        "placements": {"/ctx/a": "w1", "/ctx/b": "w2"},
        "peer_map_version": 9,
        "route_totals": {"affinity": 9, "failover": 3},
    },
    "self": {
        "poll_interval_seconds": 0.2, "oldest_poll_age_seconds": 4.0,
        "peer_map": {"version": 9, "acked": {"w0": 9, "w2": 7},
                     "stale_acks": ["w2"]},
        "decision_ring": {"size": 12,
                          "verdicts": {"affinity": 9, "failover": 3}},
        "last_progress_seconds": 0.5, "watchdog_armed": True,
    },
}

_CANNED_BUILDS = {
    "queue_depth": 3, "max_concurrent_builds": 0,
    "inflight": [
        {"id": 7, "tenant": "acme", "state": "running", "phase": "hash",
         "queue_wait_seconds": 0.2, "age_seconds": 12.0,
         "progress_age_seconds": 0.1, "worker": "w0",
         "cache": {"kv_consults": 4, "kv_hits": 3, "kv_hit_ratio": 0.75},
         "tag": "acme/app:dev"},
        {"id": -3, "tenant": "team-a", "state": "admitting",
         "phase": "", "queue_wait_seconds": 5.0, "age_seconds": 5.0,
         "progress_age_seconds": 0.0, "worker": "-", "cache": {},
         "tag": "b"}],
    "recent": [{"id": 6, "tenant": "acme", "exit_code": 0,
                "queue_wait_seconds": 0.0, "elapsed_seconds": 2.5,
                "tag": "acme/app:dev", "worker": "w0"}],
}


def test_fleet_doctor_canned_findings():
    findings = fleet_doctor.diagnose_fleet(_CANNED_HEALTH)
    kinds = {f["kind"] for f in findings}
    assert kinds >= {"dead_worker", "draining_worker", "stale_peer_map",
                     "quota_pinned", "placement_drift"}
    assert findings[0]["severity"] == "error"
    stale = [f for f in findings if f["kind"] == "stale_peer_map"]
    assert len(stale) == 1 and stale[0]["worker"] == "w2"
    rendered = fleet_doctor.render_fleet_doctor(_CANNED_HEALTH,
                                                "/tmp/fleet.sock")
    assert "worker w1 is DEAD" in rendered
    assert "pinned at its quota" in rendered
    assert "placement memo pins" in rendered


def test_fleet_readers_render_like_the_reference():
    """diagnose_fleet, render_fleet_doctor (with and without an /alerts
    payload) and render_top give the reference's output on the same
    canned front-door payloads."""
    alerts = {"active": [{"rule": "dead_worker", "severity": "warn",
                          "value": 1.0, "threshold": 1.0,
                          "message": "fleet has dead workers"}],
              "workers": {"w0": {"active": []}, "w1": {"error": "dead"}}}
    assert fleet_doctor.diagnose_fleet(_CANNED_HEALTH) \
        == ref_doctor.diagnose_fleet(_CANNED_HEALTH)
    for kwargs in ({}, {"alerts": alerts}):
        assert fleet_doctor.render_fleet_doctor(
            _CANNED_HEALTH, "/tmp/f.sock", **kwargs) \
            == ref_doctor.render_fleet_doctor(
                _CANNED_HEALTH, "/tmp/f.sock", **kwargs)
    frame = top.render_top(_CANNED_HEALTH, _CANNED_BUILDS, "/tmp/f.sock")
    assert frame == ref_top.render_top(_CANNED_HEALTH, _CANNED_BUILDS,
                                       "/tmp/f.sock")
    assert "makisu-tpu fleet" in frame and "WORKER" in frame


def _canned_fleet_events():
    tid = "ab" * 16
    return tid, [
        {"ts": 10.0, "type": "span_start", "name": "fleet_build",
         "span_id": "f" * 16, "parent_id": "0" * 15 + "1",
         "trace_id": tid},
        {"ts": 10.0, "type": "span_start", "name": "fleet_admit",
         "span_id": "a" * 16, "parent_id": "f" * 16, "trace_id": tid},
        {"ts": 10.2, "type": "span_end", "name": "fleet_admit",
         "span_id": "a" * 16, "duration": 0.2, "trace_id": tid},
        {"ts": 10.2, "type": "span_start", "name": "fleet_forward",
         "span_id": "b" * 16, "parent_id": "f" * 16, "trace_id": tid,
         "attrs": {"worker": "w0", "verdict": "affinity",
                   "attempt": "0"}},
        {"ts": 10.5, "type": "queue_wait", "seconds": 0.3, "tenant": "t",
         "trace_id": tid, "parent_id": "b" * 16, "worker": "w0"},
        {"ts": 10.5, "type": "span_start", "name": "build",
         "span_id": "c" * 16, "parent_id": "b" * 16, "trace_id": tid,
         "worker": "w0"},
        {"ts": 10.6, "type": "serve_access", "kind": "pack",
         "status": 206, "bytes": 4096, "trace_id": tid, "worker": "w1"},
        {"ts": 12.0, "type": "span_end", "name": "build",
         "span_id": "c" * 16, "duration": 1.5, "trace_id": tid,
         "worker": "w0"},
        {"ts": 12.1, "type": "span_end", "name": "fleet_forward",
         "span_id": "b" * 16, "duration": 1.9, "trace_id": tid},
        {"ts": 12.1, "type": "span_end", "name": "fleet_build",
         "span_id": "f" * 16, "duration": 2.1, "trace_id": tid},
    ]


def test_fleet_trace_assembly_matches_the_reference():
    _, lines = _canned_fleet_events()
    assembled = traceexport.assemble_fleet_trace(lines)
    assert assembled == ref_traceexport.assemble_fleet_trace(lines)
    assert traceexport.fleet_perfetto_trace(assembled) \
        == ref_traceexport.fleet_perfetto_trace(assembled)
    profile = {"samples": 40, "workers": {"w0": {}},
               "overhead_fraction": 0.01,
               "phases": {"hash": 30, "other": 10},
               "stacks": [{"stack": "main;sha", "phase": "hash",
                           "count": 30},
                          {"stack": "main;idle", "phase": "other",
                           "count": 10}]}
    for prof in (None, profile):
        assert traceexport.render_fleet_report(assembled, profile=prof) \
            == ref_traceexport.render_fleet_report(assembled, profile=prof)


def test_report_fleet_cli_renders_and_exports(tmp_path, capsys):
    tid, lines = _canned_fleet_events()
    events_path = tmp_path / "fleet-events.jsonl"
    events_path.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    trace_path = tmp_path / "merged.json"
    assert cli.main(["--trace-out", str(trace_path),
                     "report", "--fleet", str(events_path)]) == 0
    out = capsys.readouterr().out
    assert f"trace {tid}" in out
    assert "front-door quota wait 0.200s" in out
    assert "worker queue wait 0.300s" in out
    assert "attempt 0: worker w0 (affinity)" in out
    assert "critical path" in out
    assert out.startswith(ref_traceexport.render_fleet_report(
        ref_traceexport.assemble_fleet_trace(lines)))
    perfetto = json.loads(trace_path.read_text())
    names = {e["args"]["name"] for e in perfetto["traceEvents"]
             if e.get("name") == "process_name"}
    assert names == {"makisu-tpu fleet front door", "worker w0"}
    slices = [e for e in perfetto["traceEvents"] if e["ph"] == "X"]
    pid_of = {s["name"]: s["pid"] for s in slices}
    assert pid_of["build"] != pid_of["fleet_build"]
    assert pid_of["queue_wait"] == pid_of["build"]


def test_history_routing_mix_diff():
    direct = [{"schema": history_mod.HISTORY_SCHEMA, "ts": float(i),
               "duration_seconds": 1.0, "exit_code": 0,
               "cache": {"hits": 1, "misses": 1}} for i in range(4)]
    routed = [dict(r, ts=10.0 + i, fleet={
        "worker": "w0", "verdict": "affinity", "attempts": 1,
        "quota_wait_seconds": 0.0}) for i, r in enumerate(direct)]
    assert history_mod.aggregate(routed)["routing"] == "fleet"
    result = history_mod.diff(direct, routed)
    assert result["routing_change"]["candidate_worker"] == "w0"
    assert "routing mix: direct → fleet" in history_mod.render_diff(result)


def test_reference_client_builds_through_the_port_front_door(tmp_path,
                                                             fleet2):
    ctx = _make_ctx(tmp_path, "refclient")
    client = RefWorkerClient(fleet2.server.socket_path)
    assert client.build(_build_argv(tmp_path, ctx, fleet2.kv_addr),
                        tenant="ref") == 0
    terminal = client.last_build
    assert terminal["worker"] in fleet2.workers
    for key in ("fleet_verdict", "fleet_attempts", "quota_wait_seconds"):
        assert key in terminal
    assert terminal["tenant"] == "ref"


def test_front_door_accepts_a_wave_of_64_connects(tmp_path):
    """64 simultaneous connects before the first accept: all land in the
    port's backlog of 128 and are then served. The reference's backlog
    of 5 refuses most of the same wave (a reference-side fault)."""
    def wave(server):
        socks, refused = [], 0
        for _ in range(64):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.setblocking(False)
            try:
                s.connect(server.socket_path)
                socks.append(s)
            except (BlockingIOError, ConnectionRefusedError):
                refused += 1
                s.close()
        return socks, refused

    specs = [WorkerSpec("w0", str(tmp_path / "none.sock"))]
    port = FleetServer(str(tmp_path / "f.sock"), specs, poll_interval=60)
    ref = ref_server.FleetServer(
        str(tmp_path / "rf.sock"),
        [ref_scheduler.WorkerSpec("w0", str(tmp_path / "none.sock"))],
        poll_interval=60)
    try:
        assert port.request_queue_size == 128
        socks, refused = wave(port)
        assert refused == 0 and len(socks) == 64
        ref_socks, ref_refused = wave(ref)
        for s in ref_socks:
            s.close()
        assert ref_refused > 0
        port.serve_background()
        for s in socks:
            s.setblocking(True)
            s.settimeout(10)
            s.sendall(b"GET /ready HTTP/1.1\r\nHost: x\r\n"
                      b"Connection: close\r\n\r\n")
        for s in socks:
            data = b""
            while chunk := s.recv(4096):
                data += chunk
            assert data.startswith(b"HTTP/1.1 503"), data[:40]
            s.close()
    finally:
        port.shutdown()
        port.server_close()
        ref.server_close()


# -- the fleet's telemetry (tests/test_trace_propagation.py) ----------------


def _walk_named(span, name):
    out, stack = [], [span]
    while stack:
        s = stack.pop()
        if s.get("name") == name:
            out.append(s)
        stack.extend(s.get("children", []))
    return out


def test_fleet_single_trace_end_to_end(tmp_path, fleet2):
    """One trace id across the front door's admit/route/forward spans,
    the worker's queue wait and build, the drained holder's access
    ledger, the history record's provenance and the merged assembly."""
    ctx = _make_ctx(tmp_path, "tctx")
    hist = tmp_path / "history.jsonl"
    argv = ["--log-level", "error", "--history-out", str(hist),
            "build", str(ctx), "-t", "trace/fleet:1", "--hasher", "gpu",
            "--root", str(tmp_path / "root"),
            "--http-cache-addr", fleet2.kv_addr]
    reg1 = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg1)
    try:
        assert fleet2.client.build(argv, tenant="team-a") == 0
    finally:
        metrics.reset_build_registry(token)
    first = dict(fleet2.client.last_build)
    assert first["trace_id"] == reg1.trace_id
    holder = first["worker"]
    fleet2.drain(holder)
    reg2 = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg2)
    try:
        assert fleet2.client.build(argv, tenant="team-a") == 0
    finally:
        metrics.reset_build_registry(token)
    second = dict(fleet2.client.last_build)
    assert second["worker"] != holder
    assert second["trace_id"] == reg2.trace_id
    starts = [e for e in fleet2.client.last_events
              if e["type"] == "build_start"
              and e.get("command") != "fleet_build"]
    assert starts and starts[-1]["trace_id"] == reg2.trace_id
    traced = [row for row in fleet2.workers[holder].serve_access.snapshot()
              if row["trace_id"] == reg2.trace_id]
    assert any(row["kind"] in ("pack", "zpack", "chunk")
               and row["status"] in (200, 206) and row["bytes"] > 0
               for row in traced), traced
    records = history_mod.read_history(str(hist))
    assert len(records) == 2
    assert records[-1]["trace_id"] == reg2.trace_id
    assert records[-1]["fleet"]["worker"] == second["worker"]
    assert records[-1]["fleet"]["verdict"] == second["fleet_verdict"]
    assert records[-1]["fleet"]["attempts"] == 1
    assembled = traceexport.assemble_fleet_trace(
        fleet2.server.trace_events())
    by_id = {t["trace_id"]: t for t in assembled["traces"]}
    assert reg1.trace_id in by_id and reg2.trace_id in by_id
    shape = {"spans": by_id[reg2.trace_id]["spans"]}
    root = traceexport.root_span(shape)
    assert root["name"] == "fleet_build"
    [forward] = _walk_named(root, "fleet_forward")
    builds = _walk_named(forward, "build")
    assert builds and builds[0]["trace_id"] == reg2.trace_id
    assert _walk_named(forward, "queue_wait")
    path = traceexport.critical_path(shape)
    assert path[0]["name"] == "fleet_build"
    assert abs(path[0]["duration"] - (root["duration"] or 0.0)) < 1e-9
    perfetto = traceexport.fleet_perfetto_trace(assembled)
    names = {e["args"]["name"] for e in perfetto["traceEvents"]
             if e.get("name") == "process_name"}
    assert "makisu-tpu fleet front door" in names
    assert any(n.startswith("worker ") for n in names)
    rendered = traceexport.render_fleet_report(assembled)
    assert "front-door quota wait" in rendered and reg2.trace_id in rendered


class _RefusingWorker:
    """A fake worker that polls healthy, claims a resident session for
    one context (so affinity routes to it first) and refuses every build
    with 503: the deterministic failover trigger."""

    def __init__(self, socket_path, session_context):
        import socketserver
        from http.server import BaseHTTPRequestHandler
        ctx = session_context

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _json(self, payload, status=200):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/ready":
                    self._json({"ok": True})
                elif self.path == "/healthz":
                    self._json({
                        "status": "ok", "uptime_seconds": 1.0,
                        "builds_started": 0, "builds_succeeded": 0,
                        "builds_failed": 0, "active_builds": 0,
                        "queue": {"depth": 0, "max_concurrent_builds": 0,
                                  "wait_seconds": {},
                                  "latency_seconds": {},
                                  "tenant_latency_seconds": {}},
                        "serve": {}, "peer_map_version": 0,
                        "last_progress_seconds": 0.0})
                elif self.path == "/sessions":
                    self._json({"sessions": [{"context": ctx}], "hits": 1})
                else:
                    self._json({"error": "nope"}, status=404)

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", "0")))
                if self.path == "/peers":
                    self._json({"applied": True, "version": 1})
                else:
                    self._json({"error": "admission_refused"}, status=503)

        class Server(socketserver.ThreadingMixIn,
                     socketserver.UnixStreamServer):
            daemon_threads = True

            def get_request(self):
                request, _ = super().get_request()
                return request, ("refuser", 0)

        self.server = Server(socket_path, Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_fleet_failover_attempts_share_one_trace(tmp_path):
    ctx = _make_ctx(tmp_path, "fctx")
    refuser = _RefusingWorker(str(tmp_path / "refuser.sock"),
                              os.path.realpath(str(ctx)))
    real = WorkerServer(str(tmp_path / "real.sock"), device="cpu")
    real.serve_background()
    fleet = FleetServer(str(tmp_path / "ffleet.sock"), [
        WorkerSpec("refuser", str(tmp_path / "refuser.sock"),
                   str(tmp_path / "r-storage")),
        WorkerSpec("real", real.socket_path, str(tmp_path / "real-storage"))],
        poll_interval=0.2)
    fleet.serve_background()
    client = WorkerClient(fleet.socket_path)
    try:
        deadline = time.monotonic() + 30
        while True:
            if client.ready() and all(
                    w["alive"] for w in client.healthz()["fleet"]["workers"]):
                break
            assert time.monotonic() < deadline, "never ready"
            time.sleep(0.05)
        reg = metrics.MetricsRegistry()
        token = metrics.set_build_registry(reg)
        try:
            code = client.build(["--log-level", "error", "build", str(ctx),
                                 "-t", "trace/failover:1", "--hasher", "gpu",
                                 "--root", str(tmp_path / "root")],
                                tenant="t")
        finally:
            metrics.reset_build_registry(token)
        assert code == 0
        terminal = dict(client.last_build)
        assert terminal["fleet_attempts"] == 2
        assert terminal["worker"] == "real"
        assert terminal["fleet_verdict"] == "failover"
        assert terminal["trace_id"] == reg.trace_id
        assembled = traceexport.assemble_fleet_trace(fleet.trace_events())
        trace = {t["trace_id"]: t
                 for t in assembled["traces"]}[reg.trace_id]
        root = traceexport.root_span({"spans": trace["spans"]})
        assert root["name"] == "fleet_build"
        forwards = _walk_named(root, "fleet_forward")
        assert {f["attrs"]["worker"]: int(f["attrs"]["attempt"])
                for f in forwards} == {"refuser": 0, "real": 1}
        by_worker = {f["attrs"]["worker"]: f for f in forwards}
        assert not _walk_named(by_worker["refuser"], "build")
        assert _walk_named(by_worker["real"], "build")
    finally:
        fleet.shutdown()
        fleet.server_close()
        real.shutdown()
        real.server_close()
        refuser.close()


def test_fleet_aggregated_metrics_scrape(fleet2):
    text = fleet2.client.metrics()
    assert 'worker="w0"' in text and 'worker="w1"' in text
    assert re.search(r'^makisu_fleet_workers\{state="alive"\} ', text, re.M)
    types = [ln for ln in text.splitlines() if ln.startswith("# TYPE ")]
    assert len(types) == len(set(types))
    assert metrics.global_registry().counter_total(
        metrics.FLEET_AGGREGATED_SCRAPES, result="ok") >= 2


def test_fleet_healthz_self_section(fleet2):
    health = fleet2.client.healthz()
    section = health["self"]
    assert section["peer_map"]["version"] >= 1
    assert set(section["peer_map"]["acked"]) == {"w0", "w1"}
    assert section["peer_map"]["stale_acks"] == []
    assert "decision_ring" in section
    assert section["oldest_poll_age_seconds"] is not None
    assert "last_progress_seconds" in health
    assert health["role"] == "fleet"


def test_fleet_doctor_names_dead_worker_and_drift(fleet2, capsys):
    victim = fleet2.workers["w1"]
    victim.shutdown()
    victim.server_close()
    deadline = time.monotonic() + 15
    while True:
        workers = {w["id"]: w for w in fleet2.client.healthz()["fleet"][
            "workers"]}
        if not workers["w1"]["alive"]:
            break
        assert time.monotonic() < deadline
        time.sleep(0.05)
    assert cli.main(["doctor", "--fleet", fleet2.server.socket_path]) == 0
    out = capsys.readouterr().out
    assert "worker w1 is DEAD" in out and "diagnosis" in out
    # A socket in place of a bundle renders its alerts as a diagnosis.
    assert cli.main(["doctor", fleet2.server.socket_path]) == 0
    assert "fleet alerts" in capsys.readouterr().out


def test_alerts_and_profile_on_a_front_door(tmp_path, fleet2, capsys):
    assert cli.main(["alerts", fleet2.server.socket_path]) == 0
    out = capsys.readouterr().out
    assert "fleet alerts" in out and "worker w0" in out
    assert cli.main(["alerts", "--json", fleet2.server.socket_path]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["source"] == "fleet" and set(snap["workers"]) == {"w0", "w1"}
    out_path = tmp_path / "fleet-profile.json"
    assert cli.main(["profile", "--fleet", fleet2.server.socket_path,
                     "--seconds", "0.2", "--out", str(out_path)]) == 0
    merged = json.loads(out_path.read_text())
    assert merged["schema"] == "makisu-tpu.profile.v1"
    assert merged["unreachable"] == []
    assert cli.main(["top", "--socket", fleet2.server.socket_path,
                     "--once"]) == 0
    frame = capsys.readouterr().out
    assert "makisu-tpu fleet" in frame
    assert len([ln for ln in frame.splitlines()
                if re.match(r"^w[01] ", ln)]) == 2


def test_fleet_sigusr1_dumps_bundle_and_keeps_serving(tmp_path):
    """SIGUSR1 on a real port ``fleet`` process dumps a flight-recorder
    bundle, and the front door keeps serving."""
    diag = tmp_path / "diag"
    diag.mkdir()
    env = dict(os.environ, MAKISU_TPU_DIAG_DIR=str(diag),
               MAKISU_TPU_WORKER_WARM_PROBE="0")
    worker_sock = str(tmp_path / "sw.sock")
    fleet_sock = str(tmp_path / "sf.sock")
    worker = subprocess.Popen(
        [sys.executable, "-m", "makisu_tpu_torch.cli", "worker",
         "--socket", worker_sock], env=env, cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    fleet = subprocess.Popen(
        [sys.executable, "-m", "makisu_tpu_torch.cli", "fleet",
         "--socket", fleet_sock, "--worker", worker_sock,
         "--canary-interval", "0"], env=env, cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    client = WorkerClient(fleet_sock)
    try:
        deadline = time.monotonic() + 60
        while not client.ready():
            assert time.monotonic() < deadline, "fleet never ready"
            assert fleet.poll() is None, "fleet died at startup"
            time.sleep(0.1)
        fleet.send_signal(signal.SIGUSR1)
        bundle = None
        deadline = time.monotonic() + 30
        while bundle is None:
            paths = [p for p in diag.iterdir() if "SIGUSR1" in p.name
                     and p.suffix == ".json"]
            if paths:
                try:
                    bundle = json.loads(paths[0].read_text())
                except ValueError:
                    bundle = None
            if bundle is None:
                assert time.monotonic() < deadline, list(diag.iterdir())
                time.sleep(0.1)
        assert bundle["schema"] == "makisu-tpu.flightrecorder.v1"
        assert bundle["reason"] == "SIGUSR1"
        assert client.ready() and fleet.poll() is None
        # The front door process never imported torch.
        with open(f"/proc/{fleet.pid}/maps") as f:
            assert "libtorch" not in f.read()
    finally:
        for proc in (fleet, worker):
            proc.terminate()
        for proc in (fleet, worker):
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)


_READERS_SCRIPT = """
import json, os, sys, threading, time
from makisu_tpu_torch import cli
from makisu_tpu_torch.utils import mountinfo
from makisu_tpu_torch.worker import WorkerClient
mountinfo.set_mountpoints_for_testing(set())
d, worker_sock = sys.argv[1], sys.argv[2]
fleet_sock = os.path.join(d, "f.sock")
events_path = os.path.join(d, "E.jsonl")
trace_path = os.path.join(d, "T.json")
front = threading.Thread(target=cli.main, args=([
    "--log-level", "error", "--events-out", events_path,
    "--trace-out", trace_path, "fleet", "--socket", fleet_sock,
    "--worker", worker_sock, "--canary-interval", "0",
    "--poll-interval", "0.2"],))
front.start()
client = WorkerClient(fleet_sock)
deadline = time.monotonic() + 60
while not client.ready():
    assert time.monotonic() < deadline
    time.sleep(0.1)
ctx = os.path.join(d, "ctx")
os.makedirs(os.path.join(ctx, "src"))
open(os.path.join(ctx, "Dockerfile"), "w").write(
    "FROM scratch\\nCOPY src/ /src/\\n")
open(os.path.join(ctx, "src", "a.py"), "w").write("x=1\\n" * 100)
os.makedirs(os.path.join(d, "root"))
assert client.build(["--log-level", "error", "build", ctx, "-t", "r/c:1",
                     "--hasher", "cpu", "--root", os.path.join(d, "root"),
                     "--storage", os.path.join(d, "s")]) == 0
assert client.last_build["worker"] == "w0"
for argv in (["top", "--socket", fleet_sock, "--once"],
             ["doctor", "--fleet", fleet_sock], ["alerts", fleet_sock],
             ["profile", "--fleet", fleet_sock, "--seconds", "0.2"]):
    assert cli.main(argv) == 0, argv
client.exit()
front.join(timeout=60)
assert not front.is_alive()
assert cli.main(["report", "--fleet", events_path]) == 0
trace = json.load(open(trace_path))
assert any(e.get("name") == "fleet_build" for e in trace["traceEvents"])
assert "torch" not in sys.modules, "torch imported"
print("clean")
"""


def test_front_door_and_readers_import_no_torch(tmp_path):
    """The front door (in the script's own process) and the readers top,
    doctor --fleet, alerts, profile --fleet and report --fleet route and
    render without torch in sys.modules; the worker is a process of its
    own (a cpu-hasher build)."""
    worker_sock = str(tmp_path / "w.sock")
    env = dict(os.environ, MAKISU_TPU_WORKER_WARM_PROBE="0")
    worker = subprocess.Popen(
        [sys.executable, "-m", "makisu_tpu_torch.cli", "worker",
         "--socket", worker_sock], env=env, cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        out = subprocess.run([sys.executable, "-c", _READERS_SCRIPT,
                              str(tmp_path), worker_sock], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=240)
        assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
        assert out.stdout.strip().endswith("clean")
    finally:
        worker.terminate()
        try:
            worker.wait(timeout=15)
        except subprocess.TimeoutExpired:
            worker.kill()
            worker.wait(timeout=15)


def test_canary_sweep_scores_and_agrees(tmp_path, fleet2):
    """One canary sweep over two port workers (the gpu hasher on their
    plain versions): both build, score 1.0, and agree on the digests."""
    canary = slo.CanaryDriver(fleet2.server.scheduler, interval=0,
                              timeout=120, slow_seconds=120,
                              work_dir=str(tmp_path / "canary"))
    assert canary.hasher == "gpu"
    canary.sweep()
    status = canary.status()
    assert status["sweeps"] == 1 and not status["digest_mismatch"]
    rows = status["workers"]
    assert set(rows) == {"w0", "w1"}
    assert all(r["ok"] and r["score"] == 1.0 for r in rows.values())
    assert rows["w0"]["digests"] == rows["w1"]["digests"] != []
