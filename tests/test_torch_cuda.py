"""The CUDA kernels against their plain versions on the card. These need
an NVIDIA card and nvcc, and skip without CUDA; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a machine with
the card need not have; this file imports nothing of JAX.)
"""

import hashlib

import numpy as np
import pytest
import torch

from makisu_tpu_torch.chunker.cdc import ChunkSession
from makisu_tpu_torch.ops import gear, gear_cuda, sha256, sha256_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(32,), (8192,), (3, 65536 + 96)])
@pytest.mark.parametrize("head", gear.HEADS)
def test_gear_kernel_matches_plain(dev, shape, head):
    data = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=shape, dtype=np.uint8)).to(dev)
    before = gear_cuda.launches
    for avg_bits in (1, 4, 13):
        got = gear_cuda.gear_bitmap(data, avg_bits, head)
        want = gear.gear_bitmap(data, avg_bits, head)
        assert torch.equal(got.cpu(), want.cpu())
    assert gear_cuda.launches == before + 3


@pytest.mark.parametrize("rows,n", [(1, 3 * 16384 + 96), (3, 16384 + 32),
                                    (2, 2 << 20)])
def test_gear_halo_entry_matches_plain(dev, rows, n):
    """The halo entry (a row's 32 bytes before it in place of the head)
    against ``gear_bitmap_with_halo`` over the halo's G-values and
    against the unsharded stream, at lengths that end mid-tile and at the
    production shard."""
    full = torch.from_numpy(np.random.default_rng(rows).integers(
        0, 256, size=(rows, n + 64), dtype=np.uint8)).to(dev)
    x, halo = full[:, 64:].contiguous(), full[:, 32:64].contiguous()
    before = gear_cuda.launches, gear_cuda.halo_launches
    for avg_bits in (1, 4, 13):
        got = gear_cuda.gear_bitmap(x, avg_bits, halo=halo).cpu()
        assert torch.equal(got, gear.gear_bitmap_with_halo(
            x, gear.halo_values(halo), avg_bits).cpu())
        assert torch.equal(got, gear.gear_bitmap(full, avg_bits)[:, 2:]
                           .cpu())
    assert (gear_cuda.launches, gear_cuda.halo_launches) == \
        (before[0] + 3, before[1] + 3)


def test_gear_halo_entry_on_one_row(dev):
    full = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, size=8192 + 32, dtype=np.uint8)).to(dev)
    got = gear_cuda.gear_bitmap(full[32:].contiguous(), 4,
                                halo=full[:32].contiguous())
    assert torch.equal(got.cpu(), gear.gear_bitmap(full, 4)[1:].cpu())


@pytest.mark.parametrize("lanes,cap", [(64, 1024), (300, 16384)])
def test_sha256_kernel_matches_plain_and_hashlib(dev, lanes, cap):
    data, lengths = sha256_cuda.probe_inputs(lanes, cap, seed=3)
    d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
    got = sha256_cuda.sha256_lanes(d, ln).cpu().numpy()
    np.testing.assert_array_equal(got, sha256.sha256_lanes(d, ln).cpu()
                                  .numpy())
    np.testing.assert_array_equal(got, sha256_cuda.hashlib_words(data,
                                                                 lengths))


def test_sha256_kernel_flags_out_of_range_length(dev):
    data, lengths = sha256_cuda.probe_inputs(64, 1024, seed=4)
    sha256_cuda.check_lengths(dev)
    lengths[5] = 1024 - 8
    got = sha256_cuda.sha256_lanes(torch.from_numpy(data).to(dev),
                                   torch.from_numpy(lengths).to(dev))
    with pytest.raises(ValueError, match="lane length"):
        sha256_cuda.check_lengths(dev)
    sha256_cuda.check_lengths(dev)  # the check clears the flag
    empty = np.frombuffer(hashlib.sha256(b"").digest(), dtype=">u4")
    np.testing.assert_array_equal(got.cpu().numpy()[5], empty)


@pytest.mark.parametrize("offset_dtype", [np.int64, np.int32])
def test_sha256_spans_kernel_matches_plain_and_hashlib(dev, offset_dtype):
    """The parity probe's spans: every offset mod 64, the padding edges,
    and 64 KiB spans of each alignment ending at the buffer's end."""
    buf, offsets, lengths = sha256_cuda.probe_spans()
    offsets = offsets.astype(offset_dtype)
    order = np.argsort(-lengths, kind="stable")  # longest first
    b = torch.from_numpy(buf).to(dev)
    o = torch.from_numpy(offsets[order]).to(dev)
    ln = torch.from_numpy(lengths[order]).to(dev)
    before = sha256_cuda.launches
    got = sha256_cuda.sha256_spans(b, o, ln).cpu().numpy()
    assert sha256_cuda.launches == before + 1
    sha256_cuda.check_lengths(dev)
    np.testing.assert_array_equal(got, sha256.sha256_spans(b, o, ln).cpu()
                                  .numpy())
    np.testing.assert_array_equal(got, sha256_cuda.hashlib_span_words(
        buf, offsets[order], lengths[order]))


def test_sha256_spans_kernel_flags_span_outside_buffer(dev):
    buf = torch.zeros(256, dtype=torch.uint8, device=dev)
    sha256_cuda.check_lengths(dev)
    got = sha256_cuda.sha256_spans(
        buf, torch.tensor([0, 250], device=dev),
        torch.tensor([3, 7], dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="outside its buffer"):
        sha256_cuda.check_lengths(dev)
    empty = np.frombuffer(hashlib.sha256(b"").digest(), dtype=">u4")
    np.testing.assert_array_equal(got.cpu().numpy()[1], empty)


def _multi_inputs(seed: int = 9):
    """Three buffers of odd sizes and the parity probe's spans dealt
    among them (every offset mod 64, the padding edges, spans ending at
    each buffer's end)."""
    rng = np.random.default_rng(seed)
    buf, offsets, lengths = sha256_cuda.probe_spans(max_len=4096)
    bufs = [buf, rng.integers(0, 256, size=len(buf) + 3, dtype=np.uint8),
            rng.integers(0, 256, size=5_001, dtype=np.uint8)]
    index = rng.integers(0, 2, size=len(offsets))
    tail = np.array([2, 2, 2]), np.array([0, 4_999, 4_936]), \
        np.array([5_001, 2, 65])
    index = np.concatenate([index, tail[0]])
    offsets = np.concatenate([offsets, tail[1]])
    lengths = np.concatenate([lengths, tail[2]])
    order = np.argsort(-lengths, kind="stable")
    return bufs, index[order], offsets[order], lengths[order]


def test_sha256_multi_kernel_matches_plain_and_hashlib(dev):
    bufs, index, offsets, lengths = _multi_inputs()
    on_card = [torch.from_numpy(b).to(dev) for b in bufs]
    errors = sha256_cuda.LaunchErrors()
    before = sha256_cuda.multi_launches
    got = sha256_cuda.sha256_multi(on_card, index, offsets, lengths,
                                   errors=errors).cpu().numpy()
    assert sha256_cuda.multi_launches == before + 1
    errors.check()
    want = sha256.sha256_multi([torch.from_numpy(b) for b in bufs],
                               torch.from_numpy(index),
                               torch.from_numpy(offsets),
                               torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, want)
    raw = b"".join(hashlib.sha256(bufs[i][o:o + n].tobytes()).digest()
                   for i, o, n in zip(index, offsets, lengths))
    np.testing.assert_array_equal(got, np.frombuffer(raw, ">u4").reshape(
        -1, 8))


def test_sha256_multi_kernel_flags_span_outside_its_buffer(dev):
    """A span inside a larger buffer of the launch but past the end of
    its own sets the launch's error word and hashes as the empty
    message."""
    small = torch.zeros(100, dtype=torch.uint8, device=dev)
    large = torch.zeros(4096, dtype=torch.uint8, device=dev)
    errors = sha256_cuda.LaunchErrors()
    got = sha256_cuda.sha256_multi([small, large], [0, 1, 0], [0, 0, 90],
                                   [100, 4096, 20], errors=errors)
    with pytest.raises(ValueError, match="outside its buffer"):
        errors.check()
    empty = np.frombuffer(hashlib.sha256(b"").digest(), dtype=">u4")
    np.testing.assert_array_equal(got.cpu().numpy()[2], empty)
    errors.check()  # read once, then forgotten


def test_launch_error_raises_only_in_its_own_thread(dev):
    """Two threads, each on a stream of its own: one launches a span past
    its buffer's end, the other a good span. Only the first raises, even
    when the second checks first, and the second's digest is hashlib's
    (one error word per launch, not per device)."""
    import threading

    data = np.random.default_rng(10).integers(0, 256, size=8192,
                                              dtype=np.uint8)
    launched = threading.Barrier(2)
    checked = threading.Event()
    out = {}

    def run(name, offset, length):
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            buf = torch.from_numpy(data).to(dev)
            got = sha256_cuda.sha256_spans(
                buf, torch.tensor([offset], device=dev),
                torch.tensor([length], dtype=torch.int32, device=dev))
            launched.wait(timeout=60)
            if name == "bad":
                checked.wait(timeout=60)
            try:
                sha256_cuda.check_lengths(dev)
                out[name] = got.cpu().numpy()
            except ValueError as e:
                out[name] = e
            if name == "good":
                checked.set()

    threads = [threading.Thread(target=run, args=("bad", 8000, 500)),
               threading.Thread(target=run, args=("good", 17, 5000))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert isinstance(out["bad"], ValueError)
    want = np.frombuffer(hashlib.sha256(data[17:5017].tobytes()).digest(),
                         dtype=">u4")
    np.testing.assert_array_equal(out["good"][0], want)


def test_service_sessions_on_card_match_cpu(dev, monkeypatch):
    """Concurrent sessions on the card whose ring passes go through one
    hash service (rings of 3 slots, so every session wraps) cut and hash
    as sessions on the CPU without one, in fewer S1 launches than
    passes, some of them shared by several sessions."""
    import threading

    from makisu_tpu_torch.chunker.service import HashService

    monkeypatch.setattr(ChunkSession, "RING_BLOCKS", 3)
    payloads = [np.random.default_rng(40 + i).integers(
        0, 256, size=700_000, dtype=np.uint8).tobytes() for i in range(6)]
    svc = HashService(linger_seconds=0.2, device=dev)
    try:
        before = sha256_cuda.multi_launches
        got = {}

        def build(i):
            s = ChunkSession(block=64 * 1024, device=dev, service=svc)
            for k in range(0, len(payloads[i]), 30_001):
                s.update(payloads[i][k:k + 30_001])
            got[i] = (s.finish(), s.service_passes, s.span_launches)

        threads = [threading.Thread(target=build, args=(i,))
                   for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        passes = sum(v[1] for v in got.values())
        assert sha256_cuda.multi_launches - before == svc.batches < passes
        assert svc.cross_build_batches >= 1
        for i, payload in enumerate(payloads):
            cpu = ChunkSession(block=64 * 1024, device="cpu")
            cpu.update(payload)
            assert got[i][0] == cpu.finish()
            assert got[i][2] == 0  # no S1 launch of the session's own
    finally:
        svc.close()


def test_ring_session_on_card_matches_cpu_across_wraps(dev, monkeypatch):
    monkeypatch.setattr(ChunkSession, "RING_BLOCKS", 3)
    rng = np.random.default_rng(6)
    data = b"".join(
        rng.integers(0, 256, size=int(rng.integers(1, 200_000)),
                     dtype=np.uint8).tobytes() + bytes(100_000)
        for _ in range(6))

    def run(device):
        s = ChunkSession(block=32 * 1024, device=device)
        for i in range(0, len(data), 9_999):
            s.update(data[i:i + 9_999])
        return s.finish(), s.span_launches

    sha256_cuda.parity_probe(dev)  # its launch is not the session's
    before = sha256_cuda.launches
    got, launches = run(dev)
    assert sha256_cuda.launches == before + launches
    assert launches == -(-len(data) // (3 * 32 * 1024))
    assert (got, launches) == run("cpu")
    mv = memoryview(data)
    assert all(hashlib.sha256(mv[c.offset:c.offset + c.length]).digest()
               == c.digest for c in got)


def test_session_on_card_matches_cpu(dev):
    data = np.random.default_rng(5).integers(
        0, 256, size=3_000_000, dtype=np.uint8).tobytes()

    def run(device):
        s = ChunkSession(block=1 << 20, device=device)
        for i in range(0, len(data), 65536):
            s.update(data[i:i + 65536])
        return s.finish()

    before = gear_cuda.launches
    assert run(dev) == run("cpu")
    assert gear_cuda.launches == before + 3


def test_session_keeps_its_stream_across_threads(dev):
    """A session made under a side stream launches there even when
    another thread, whose current stream is the default one, feeds it
    (the native sink's tap runs on the writer's thread)."""
    import threading

    data = np.random.default_rng(7).integers(
        0, 256, size=3_000_000, dtype=np.uint8).tobytes()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        session = ChunkSession(block=1 << 20, device=dev)
    assert session._stream == side
    out = []

    def feed():
        assert torch.cuda.current_stream(dev) != side
        for i in range(0, len(data), 65536):
            session.update(data[i:i + 65536])
        out.extend(session.finish())

    t = threading.Thread(target=feed)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    cpu = ChunkSession(block=1 << 20, device="cpu")
    cpu.update(data)
    assert out == cpu.finish()


@pytest.mark.parametrize("backend_id", ["zlib-1", "pgzip-6-131072"])
def test_native_sink_on_card_matches_python_sink(dev, tmp_path,
                                                 backend_id):
    from makisu_tpu_torch.chunker import hasher

    data = np.random.default_rng(8).integers(
        0, 64, size=6_000_000, dtype=np.uint8).tobytes()
    got = {}
    for route in ("python", "native"):
        path = tmp_path / f"{route}.gz"
        session = ChunkSession(block=1 << 20, device=dev)
        with open(path, "wb") as out:
            sink = (hasher.NativeLayerSink(out, backend_id, session=session)
                    if route == "native"
                    else hasher._GPUSink(out, session, backend_id))
            for i in range(0, len(data), 16384):
                sink.write(data[i:i + 16384])
            commit = sink.finish()
        got[route] = (commit.digest_pair.tar_digest.hex(),
                      commit.digest_pair.gzip_descriptor.digest.hex(),
                      [(c.offset, c.length, c.hex_digest)
                       for c in commit.chunks], path.read_bytes())
    assert got["python"] == got["native"]
    assert got["native"][0] == hashlib.sha256(data).hexdigest()


def test_registry_build_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """FROM a base in a loopback registry, built with ``--push`` once on
    the card and once on the plain versions: the same pushed manifest
    layers and cache entries, and the card's kernels were launched."""
    import json

    from makisu_tpu_torch import cli
    from makisu_tpu_torch.docker.image import ImageName
    from makisu_tpu_torch.registry import RegistryClient, make_test_image
    from makisu_tpu_torch.snapshot import memfs
    from makisu_tpu_torch.storage import ImageStore
    from makisu_tpu_torch.tools.miniregistry import MiniRegistry
    from makisu_tpu_torch.utils import mountinfo

    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    mountinfo.set_mountpoints_for_testing(set())
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "data.bin").write_bytes(np.random.default_rng(6).integers(
        0, 256, size=600_000, dtype=np.uint8).tobytes())
    try:
        with MiniRegistry() as reg:
            manifest, _, blobs = make_test_image({"etc/base": b"base\n"})
            base_store = ImageStore(str(tmp_path / "base"))
            for hex_digest, blob in blobs.items():
                base_store.layers.write_bytes(hex_digest, blob)
            name = ImageName(reg.addr, "lib/base", "1")
            base_store.manifests.save(name, manifest)
            RegistryClient(base_store, reg.addr, "lib/base").push(name)
            (ctx / "Dockerfile").write_text(
                f"FROM {reg.addr}/lib/base:1\nCOPY data.bin /data.bin\n")
            entries = {}
            for device, repo in ((None, "card/app"), ("cpu", "plain/app")):
                storage = tmp_path / repo.replace("/", "-")
                root = tmp_path / f"root-{repo.split('/')[0]}"
                root.mkdir()
                before = gear_cuda.launches
                assert cli.main(["build", str(ctx), "-t", f"{repo}:1",
                                 "--storage", str(storage), "--root",
                                 str(root), "--push", reg.addr,
                                 "--gzip-backend", "pgzip"],
                                device=device) == 0
                if device is None:
                    assert gear_cuda.launches > before
                with open(storage / "cache_key_value.json") as f:
                    entries[repo] = json.load(f)
            layers = [json.loads(reg.state.repos[r].manifests["1"][1])
                      ["layers"] for r in ("card/app", "plain/app")]
            assert layers[0] == layers[1] and len(layers[0]) == 2
            strip = [{k: v for k, (v, _ts) in e.items()}
                     for e in entries.values()]
            assert strip[0] == strip[1]
    finally:
        mountinfo.set_mountpoints_for_testing(None)


def _trace_events(prof, path):
    """The chrome trace of ``prof`` as a list of complete events."""
    import json

    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _kernel_seconds(events, lo=float("-inf"), hi=float("inf")):
    """CUPTI seconds of the G1 and S1 kernels that start in [lo, hi]."""
    return sum(e["dur"] for e in events if e.get("cat") == "kernel"
               and ("gear_bitmap_kernel" in e["name"]
                    or "sha256_spans_kernel" in e["name"])
               and lo <= e["ts"] <= hi) / 1e6


def test_session_device_seconds_match_cupti(dev, tmp_path):
    """A session's ``device_seconds`` (a pair of CUDA timing events
    around each G1 and S1 launch) is within 15% of the CUPTI time of the
    same launches, and lands in ``makisu_device_busy_seconds_total``."""
    from makisu_tpu_torch.utils import metrics

    data = np.random.default_rng(9).integers(
        0, 256, size=64 << 20, dtype=np.uint8).tobytes()
    warm = ChunkSession(device=dev)  # libraries loaded, first launches
    warm.update(data[:1 << 20])
    warm.finish()
    g = metrics.global_registry()
    before = g.counter_total(metrics.DEVICE_BUSY_SECONDS)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        session = ChunkSession(device=dev)
        for i in range(0, len(data), 1 << 20):
            session.update(data[i:i + (1 << 20)])
        session.finish()
    cupti = _kernel_seconds(_trace_events(prof, tmp_path / "t.json"))
    assert cupti > 0
    assert abs(session.device_seconds - cupti) <= 0.15 * cupti
    assert g.counter_total(metrics.DEVICE_BUSY_SECONDS) - before == \
        pytest.approx(session.device_seconds)


def test_profiled_build_on_card_annotates_its_spans(dev, tmp_path):
    """A ``--torch-profile`` build on the card: every port span is a
    ``user_annotation`` on the kernels' timeline, each G1 and S1 kernel
    of the commit lies in ``commit.tar_write`` or ``commit.sink_finish``
    (the final block is dispatched at finish), and the
    committed layer's ``device_s`` is within 15% of the CUPTI time of
    the kernels inside its ``commit_layer``."""
    import json

    from makisu_tpu_torch import cli
    from makisu_tpu_torch.utils import metrics, mountinfo
    from makisu_tpu_torch.worker import session

    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "data.bin").write_bytes(np.random.default_rng(10).integers(
        0, 256, size=24 << 20, dtype=np.uint8).tobytes())
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY data.bin /data.bin\n")
    (tmp_path / "root").mkdir()
    mountinfo.set_mountpoints_for_testing(set())
    mgr = session.SessionManager()
    token = session.bind_manager(mgr)
    try:
        assert cli.main([
            "--log-fmt", "json", "--log-output", str(tmp_path / "log"),
            "--torch-profile", str(tmp_path / "prof"), "build", str(ctx),
            "-t", "card/app:1", "--storage", str(tmp_path / "s"),
            "--root", str(tmp_path / "root")]) == 0
    finally:
        session.reset_manager(token)
        mgr.reset()
        mountinfo.set_mountpoints_for_testing(None)
    [path] = (tmp_path / "prof").glob("torch-profile-*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    assert set(metrics.PORT_SPANS) <= set(spans)
    [(c0, c1)] = spans["commit_layer"]
    [write] = spans["commit.tar_write"]
    [finish] = spans["commit.sink_finish"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and c0 <= e["ts"] <= c1]
    gear = [e for e in kernels if "gear_bitmap_kernel" in e["name"]]
    sha = [e for e in kernels if "sha256_spans_kernel" in e["name"]]
    assert len(gear) >= 6 and len(sha) == 1

    def inside(e, span):
        return span[0] <= e["ts"] and e["ts"] + e["dur"] <= span[1]

    assert all(inside(e, write) or inside(e, finish) for e in gear + sha)
    [commit] = [json.loads(line) for line in
                (tmp_path / "log").read_text().splitlines()
                if "committed layer" in line]
    cupti = _kernel_seconds(kernels)
    assert abs(commit["device_s"] - cupti) <= 0.15 * cupti
