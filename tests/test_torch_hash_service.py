"""The port's shared hash service on the CPU (the multi-buffer S1's plain
version), held against the JAX package's ``HashService`` and hashlib:
every case of ``tests/test_hash_service.py``, with the request shape the
port adds (a chunk session's ring pass), the multi-buffer plain version,
the linger knob, backpressure and ``close``."""

import hashlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from makisu_tpu.chunker.cdc import ChunkSession as RefSession
from makisu_tpu.chunker.service import HashService as RefService
from makisu_tpu.ops import sha256 as jsha
from makisu_tpu_torch.chunker import cdc, service as service_mod
from makisu_tpu_torch.chunker.cdc import ChunkSession
from makisu_tpu_torch.chunker.service import HashService
from makisu_tpu_torch.ops import backend, sha256, sha256_cuda
from makisu_tpu_torch.utils import concurrency, metrics


def rand_bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def chunks_of(session, data, step=50_001):
    for i in range(0, len(data), step):
        session.update(data[i:i + step])
    return [(c.offset, c.length, c.digest) for c in session.finish()]


def submit_bytes(svc, data, owner=None):
    """One chunk's bytes as a one-span pass of a ring of their own (the
    reference's request shape: a chunk's bytes)."""
    ring = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    return svc.submit_pass(ring, [0], [len(data)], owner=owner,
                           h2d=len(data))


def digest_of(req) -> bytes:
    return req.future.result(timeout=60)[0].astype(">u4").tobytes()


@pytest.fixture
def service():
    svc = HashService(linger_seconds=0.02, device="cpu")
    yield svc
    svc.close()


@pytest.fixture
def small_ring(monkeypatch):
    """Rings of 3 slots, so a few hundred KB wrap them several times."""
    monkeypatch.setattr(ChunkSession, "RING_BLOCKS", 3)


@pytest.fixture
def xla_reference(monkeypatch):
    """The reference session on its device (XLA) route."""
    monkeypatch.setenv("MAKISU_TPU_CHUNK_NATIVE", "0")


# -- the multi-buffer entry's plain version ------------------------------------


@pytest.mark.parametrize("lead", [0, 1, 2, 3])
def test_multi_plain_matches_hashlib_and_reference_lanes(lead):
    """Spans of three buffers, each starting at ``lead`` mod 4 with the
    padding-edge lengths: equal to hashlib and to the reference's
    ``sha256_lanes`` on the same messages."""
    rng = np.random.default_rng(30 + lead)
    bufs = [rng.integers(0, 256, size=n, dtype=np.uint8)
            for n in (9_000, 4_099, 777)]
    index, offsets, lengths = [], [], []
    for k, n in enumerate((0, 1, 55, 56, 63, 64, 100, 700)):
        b = k % 3
        index.append(b)
        offsets.append(lead + 4 * int(rng.integers(0, 8)))
        lengths.append(min(n, len(bufs[b]) - offsets[-1]))
    got = sha256_cuda.sha256_multi([torch.from_numpy(b) for b in bufs],
                                   index, offsets, lengths).numpy()
    msgs = [bufs[b][o:o + n].tobytes()
            for b, o, n in zip(index, offsets, lengths)]
    want = b"".join(hashlib.sha256(m).digest() for m in msgs)
    np.testing.assert_array_equal(got, np.frombuffer(want, ">u4")
                                  .reshape(-1, 8))
    cap = 768
    lanes = np.zeros((len(msgs), cap), dtype=np.uint8)
    for i, m in enumerate(msgs):
        lanes[i, :len(m)] = np.frombuffer(m, dtype=np.uint8)
    np.testing.assert_array_equal(got, np.asarray(jsha.sha256_lanes(
        lanes, np.array(lengths, dtype=np.int32))))


def test_multi_plain_refuses_a_span_outside_its_buffer():
    small, large = torch.zeros(10, dtype=torch.uint8), \
        torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError, match="inside the buffer"):
        sha256.sha256_multi([small, large], torch.tensor([0]),
                            torch.tensor([5]), torch.tensor([50]))
    with pytest.raises(ValueError, match="buffer indices"):
        sha256.sha256_multi([small], torch.tensor([1]), torch.tensor([0]),
                            torch.tensor([1]))


# -- the reference's cases ------------------------------------------------------


def test_service_digests_correct(service):
    payloads = [rand_bytes(5000 + i * 137, i) for i in range(40)]
    reqs = [submit_bytes(service, p) for p in payloads]
    for p, req in zip(payloads, reqs):
        assert digest_of(req) == hashlib.sha256(p).digest()


def test_service_batches_across_submitters(service):
    payloads = [rand_bytes(4000, 100 + i) for i in range(64)]
    futures = []
    lock = threading.Lock()

    def submitter(chunk):
        req = submit_bytes(service, chunk, owner=chunk)
        with lock:
            futures.append((chunk, req))

    threads = [threading.Thread(target=submitter, args=(p,))
               for p in payloads]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for chunk, req in futures:
        assert digest_of(req) == hashlib.sha256(chunk).digest()
    # Batching happened: far fewer launches than requests.
    assert service.batches < len(payloads)


def test_sessions_with_service_match_without(service, small_ring,
                                             xla_reference):
    """A session on the service equals one without it and the
    reference's session on the reference's service, on a stream that
    wraps the port's ring three times."""
    payload = rand_bytes(300_000, 7)
    without = chunks_of(ChunkSession(block=32 * 1024, device="cpu"),
                        payload)
    session = ChunkSession(block=32 * 1024, device="cpu", service=service)
    assert chunks_of(session, payload) == without
    assert session.service_passes == -(-len(payload) // (3 * 32 * 1024))
    assert session.span_launches == 0
    ref = RefService(linger_seconds=0.02)
    try:
        assert chunks_of(RefSession(block=64 * 1024, service=ref),
                         payload) == without
    finally:
        ref.close()


def test_concurrent_sessions_through_service(service, small_ring):
    payloads = [rand_bytes(200_000, 200 + i) for i in range(6)]
    results = {}

    def build(i):
        s = ChunkSession(block=32 * 1024, device="cpu", service=service)
        s.update(payloads[i])
        results[i] = s.finish()

    threads = [threading.Thread(target=build, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, payload in enumerate(payloads):
        chunks = results[i]
        assert sum(c.length for c in chunks) == len(payload)
        for c in chunks:
            assert c.digest == hashlib.sha256(
                payload[c.offset:c.offset + c.length]).digest()


def test_cross_build_batches_mix_sessions(small_ring):
    """Passes of two concurrent sessions land in shared launches. A long
    linger makes the mixing certain: both sessions' first passes are
    queued before the first batch goes."""
    svc = HashService(linger_seconds=0.5, device="cpu")
    try:
        payloads = [rand_bytes(150_000, 300 + i) for i in range(2)]
        barrier = threading.Barrier(2)
        results = {}

        def build(i):
            s = ChunkSession(block=32 * 1024, device="cpu", service=svc)
            barrier.wait()
            s.update(payloads[i])
            results[i] = (s.finish(), s.service_passes)

        threads = [threading.Thread(target=build, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, payload in enumerate(payloads):
            for c in results[i][0]:
                assert c.digest == hashlib.sha256(
                    payload[c.offset:c.offset + c.length]).digest()
        passes = sum(p for _, p in results.values())
        assert svc.passes == passes
        assert svc.batches < passes  # batching happened at all
        assert svc.cross_build_batches >= 1  # ...and across sessions
    finally:
        svc.close()


def test_full_build_with_shared_hasher(tmp_path, monkeypatch):
    """A build through ``cli.main`` with ``MAKISU_TPU_SHARED_HASH=1``
    (what a worker sets) sends its ring passes to the process service
    and gives the chunk list, cache IDs and manifest of the build with
    the service off and of the reference's shared build."""
    from makisu_tpu import cli as ref_cli
    from makisu_tpu.chunker import service as ref_service_mod
    from makisu_tpu.snapshot import memfs as ref_memfs
    from makisu_tpu.worker import session as ref_session
    from makisu_tpu_torch import cli
    from makisu_tpu_torch.snapshot import memfs
    from makisu_tpu_torch.utils import mountinfo
    from makisu_tpu_torch.worker import session as session_mod

    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "data.bin").write_bytes(rand_bytes(100_000, 5))
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY data.bin /d\n")
    mountinfo.set_mountpoints_for_testing(set())
    # COPY-only builds: MemFS's one-second mtime wait orders nothing.
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    monkeypatch.setattr(ref_memfs.MemFS, "_sync", lambda self: None)
    port_svc = HashService(linger_seconds=0.02, device="cpu")
    ref_svc = RefService(linger_seconds=0.02)
    monkeypatch.setitem(service_mod._services, "cpu", port_svc)
    monkeypatch.setattr(ref_service_mod, "_global_service", ref_svc)
    out = {}
    try:
        for name, shared in (("off", "0"), ("on", "1"), ("ref", "1")):
            monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", shared)
            root = tmp_path / f"root-{name}"
            root.mkdir()
            argv = ["--log-level", "error", "build", str(ctx), "-t",
                    "svc/build:1", "--storage", str(tmp_path / name),
                    "--root", str(root)]
            if name == "ref":
                monkeypatch.setenv("MAKISU_TPU_CHUNK_NATIVE", "0")
                mgr = ref_session.SessionManager()
                token = ref_session.bind_manager(mgr)
                try:
                    assert ref_cli.main(argv + ["--hasher", "tpu"]) == 0
                finally:
                    ref_session.reset_manager(token)
                    mgr.reset()
            else:
                mgr = session_mod.SessionManager()
                token = session_mod.bind_manager(mgr)
                try:
                    assert cli.main(argv + ["--hasher", "gpu"],
                                    device="cpu") == 0
                finally:
                    session_mod.reset_manager(token)
                    mgr.reset()
            storage = tmp_path / name
            kv = json.loads((storage / "cache_key_value.json").read_text())
            entries = {k: json.loads(v) for k, (v, _) in kv.items()
                       if v.startswith("{")}
            manifest = json.loads((storage / "manifests" / "svc" / "build"
                                   / "1.json").read_text())
            out[name] = ({k: (e["chunks"], e["tar"], e["gzip"])
                          for k, e in entries.items()},
                         manifest["layers"])
        assert port_svc.passes >= 1 and ref_svc.batches >= 1
    finally:
        port_svc.close()
        ref_svc.close()
        mountinfo.set_mountpoints_for_testing(None)
    assert out["on"] == out["off"] == out["ref"]
    assert any(chunks for chunks, _, _ in out["on"][0].values())


def _histogram(name):
    series = metrics.global_registry().report()["histograms"].get(name, [])
    return (sum(s["count"] for s in series), sum(s["sum"] for s in series))


def test_batch_occupancy_metric(service):
    """Every batch observes makisu_hash_batch_occupancy (passes / the
    service's largest batch) and makisu_hash_batch_fill (passes per
    launch) in the process registry."""
    count_before, _ = _histogram(metrics.HASH_BATCH_OCCUPANCY)
    fill_before, fill_sum_before = _histogram(metrics.HASH_BATCH_FILL)
    payloads = [rand_bytes(4000, 400 + i) for i in range(8)]
    for p, req in [(p, submit_bytes(service, p)) for p in payloads]:
        assert digest_of(req) == hashlib.sha256(p).digest()
    count_after, sum_after = _histogram(metrics.HASH_BATCH_OCCUPANCY)
    fill_after, fill_sum_after = _histogram(metrics.HASH_BATCH_FILL)
    batches = count_after - count_before
    assert batches >= 1
    assert batches == service.batches == fill_after - fill_before
    assert fill_sum_after - fill_sum_before == service.passes == 8
    assert 0 < sum_after / count_after <= 1.0


def test_device_dispatch_telemetry(service):
    """Every launch exports the device plane's set under the service's
    bucket: a dispatch latency observation (and the ring /healthz
    serves), the first-launch gauge, the H2D bytes of the span metadata
    and the requests' bytes, and no padding (spans ship no padding)."""
    g = metrics.global_registry()
    before_h2d = g.counter_total(metrics.DEVICE_H2D_BYTES)
    before_waste = g.counter_total(metrics.DEVICE_PADDING_WASTE)
    payloads = [rand_bytes(4000, 500 + i) for i in range(8)]
    for p, req in [(p, submit_bytes(service, p)) for p in payloads]:
        assert digest_of(req) == hashlib.sha256(p).digest()
    h2d = g.counter_total(metrics.DEVICE_H2D_BYTES) - before_h2d
    # Each request: its bytes, one span's metadata, its buffer's size.
    assert h2d == 8 * (4000 + sha256_cuda.MULTI_META_BYTES + 8)
    assert g.counter_total(metrics.DEVICE_PADDING_WASTE) == before_waste
    stats = backend.dispatch_stats()
    assert stats[str(service.bucket)]["count"] >= 1
    health = backend.device_health()
    assert health["h2d_bytes"] > 0
    assert str(service.bucket) in health["dispatch_seconds"]


# -- what the port adds -----------------------------------------------------------


def test_linger_knob(monkeypatch):
    concurrency.set_hash_linger_ms(None)
    monkeypatch.delenv("MAKISU_TPU_HASH_LINGER_MS", raising=False)
    assert concurrency.hash_linger_ms() == 2.0
    monkeypatch.setenv("MAKISU_TPU_HASH_LINGER_MS", "7.5")
    assert concurrency.hash_linger_ms() == 7.5
    svc = HashService(device="cpu")
    try:
        assert svc.linger == 0.0075
    finally:
        svc.close()
    monkeypatch.setenv("MAKISU_TPU_HASH_LINGER_MS", "junk")
    assert concurrency.hash_linger_ms() == 2.0
    concurrency.set_hash_linger_ms(0.5)
    try:
        assert concurrency.hash_linger_ms() == 0.5
    finally:
        concurrency.set_hash_linger_ms(None)


def test_a_bad_span_fails_every_future_of_its_batch():
    """A pass with a span outside its ring fails its whole batch: the
    plain version raises, and every future of the batch carries it."""
    svc = HashService(linger_seconds=0.3, device="cpu")
    try:
        ring = torch.from_numpy(np.frombuffer(rand_bytes(1000, 1),
                                              np.uint8).copy())
        good = svc.submit_pass(ring, [0], [100], owner="a")
        bad = svc.submit_pass(ring, [990], [20], owner="b")
        for req in (good, bad):
            with pytest.raises(ValueError, match="inside the buffer"):
                req.future.result(timeout=60)
            assert req.launched.is_set()
        assert metrics.global_registry().counter_total(
            metrics.HASH_BATCH_FAILURES) >= 1
    finally:
        svc.close()


def test_pass_digests_come_back_in_request_order(service):
    """Digests of a pass come back in its own span order, whatever order
    the batch launched them in (longest first across passes)."""
    data = np.frombuffer(rand_bytes(50_000, 2), np.uint8).copy()
    ring = torch.from_numpy(data)
    offsets, lengths = [0, 10_000, 3], [5, 30_000, 9_000]
    req = service.submit_pass(ring, offsets, lengths, owner="x")
    other = service.submit_pass(ring, [7], [40_000], owner="y")
    got = req.future.result(timeout=60)
    want = b"".join(hashlib.sha256(data[o:o + n].tobytes()).digest()
                    for o, n in zip(offsets, lengths))
    np.testing.assert_array_equal(got, np.frombuffer(want, ">u4")
                                  .reshape(-1, 8))
    assert other.future.result(timeout=60)[0].astype(">u4").tobytes() == \
        hashlib.sha256(data[7:40_007].tobytes()).digest()


def test_submit_blocks_when_the_queue_is_full_and_close_fails_the_rest(
        monkeypatch):
    """Backpressure: past QUEUE_DEPTH_BATCHES full batches of waiting
    passes, submit blocks; close fails every pass still queued."""
    monkeypatch.setattr(HashService, "QUEUE_DEPTH_BATCHES", 1)
    svc = HashService(linger_seconds=0.0, device="cpu", max_batch=1)
    gate = threading.Event()
    running = threading.Event()
    real_run = svc._run_batch

    def slow_run(batch):
        running.set()
        gate.wait(timeout=60)
        real_run(batch)

    monkeypatch.setattr(svc, "_run_batch", slow_run)
    ring = torch.zeros(64, dtype=torch.uint8)
    first = svc.submit_pass(ring, [0], [1])
    assert running.wait(timeout=30)  # the dispatcher holds the first
    queued = svc.submit_pass(ring, [0], [2])  # fills the queue (1 slot)
    third = {}

    def submit_third():
        try:
            svc.submit_pass(ring, [0], [3])
        except RuntimeError as e:
            third["error"] = e

    t = threading.Thread(target=submit_third)
    t.start()
    time.sleep(0.3)
    assert t.is_alive()  # blocked in submit
    closer = threading.Thread(target=svc.close)
    closer.start()
    t.join(timeout=30)
    assert "hash service closed" in str(third["error"])
    gate.set()  # the dispatcher finishes the pass it holds, then stops
    closer.join(timeout=30)
    assert first.future.result(timeout=60)[0].astype(">u4").tobytes() == \
        hashlib.sha256(bytes(1)).digest()
    with pytest.raises(RuntimeError, match="hash service closed"):
        queued.future.result(timeout=10)
    assert queued.launched.is_set()
    with pytest.raises(RuntimeError, match="hash service closed"):
        svc.submit_pass(ring, [0], [1])


def test_shared_service_is_one_per_device():
    a = service_mod.shared_service("cpu")
    assert service_mod.shared_service("cpu") is a
    assert a.device.type == "cpu"


def test_service_refuses_a_ring_of_another_device(service):
    with pytest.raises(ValueError, match="hash service on"):
        service.submit_pass(torch.zeros(8, dtype=torch.uint8,
                                        device="meta"), [0], [1])
    with pytest.raises(ValueError, match="hash service on"):
        ChunkSession(device="cpu", service=type(
            "S", (), {"device": torch.device("meta")})())


def test_service_and_session_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HashService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        service_mod.shared_service()


def test_gpu_hasher_shared_from_env(monkeypatch):
    from makisu_tpu_torch.chunker import hasher
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "1")
    assert hasher.get_hasher("gpu", device="cpu").shared
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")
    assert not hasher.get_hasher("gpu", device="cpu").shared
    monkeypatch.delenv("MAKISU_TPU_SHARED_HASH")
    assert not hasher.get_hasher("gpu", device="cpu").shared


def test_cdc_ring_default_is_the_service_bucket(service):
    assert service.bucket == cdc.ChunkSession.RING_BLOCKS * cdc.BLOCK


def test_a_spent_session_holds_no_ring(service, small_ring):
    """Once a service session finished, neither it nor its requests keep
    its ring alive (a worker runs wave after wave of builds)."""
    import gc
    import weakref

    session = ChunkSession(block=32 * 1024, device="cpu", service=service)
    ring = weakref.ref(session._ring)
    session.update(rand_bytes(200_000, 9))
    session.finish()
    gc.collect()
    assert ring() is None
