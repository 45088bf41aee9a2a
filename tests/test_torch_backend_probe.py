"""The port's device-plane probe (``makisu_tpu_torch/ops/backend.py``):
bounded wait, process-cached result, late-success pickup, the
cross-process wedge cache, ``sync_bounded``, and the chunk session, the
hash service and ``SnapshotHasher`` raising when the card cannot come up.

Every case of the reference's ``tests/test_backend_probe.py`` with a
counterpart, on the port's probe. The reference degrades (whole-layer
caching, no fingerprints) unless ``MAKISU_TPU_CHUNK_STRICT=1``; the port
has no degrade, so its degrade cases are raise cases. A wedge on the card
is simulated by monkeypatching a phase, as the reference does; a session
"on the card" on this CPU-only host is one whose device resolves to
``cuda`` (``torch.cuda.is_available`` patched), and it must raise before
it touches anything of CUDA. ``sync_bounded`` takes stand-ins with
``query()``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from makisu_tpu_torch.ops import backend


@pytest.fixture
def fresh_probe(monkeypatch):
    """Reset the module's cached probe state around a test, and join any
    probe thread it started while its state is still current."""
    monkeypatch.setattr(backend, "_done", threading.Event())
    monkeypatch.setattr(backend, "_result", [None])
    monkeypatch.setattr(backend, "_started", False)
    monkeypatch.setattr(backend, "_probe_start", 0.0)
    monkeypatch.setattr(backend, "_timed_out", False)
    monkeypatch.setattr(backend, "_grace_spent", False)
    monkeypatch.setattr(backend, "_tracker", backend._ProbeTracker())
    release = threading.Event()
    yield release
    release.set()
    for t in threading.enumerate():
        if t.name == "cuda-backend-probe":
            t.join(timeout=15)


def _second_process(monkeypatch=None):
    """Fresh in-process probe state, as a new process has (the verdict
    file stays)."""
    backend._done = threading.Event()
    backend._result = [None]
    backend._started = False
    backend._timed_out = False
    backend._grace_spent = False
    backend._tracker = backend._ProbeTracker()


def _hang_probe():
    pass  # never sets _done: a wedged init


@pytest.fixture
def card(monkeypatch):
    """A host whose device resolves to the card: ``resolve_device(None)``
    passes its CUDA check, so what follows must raise before it touches
    CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(backend, "_route", None)


def _parked_context_init(release):
    def phase(ctx):
        release.wait(30.0)
    return phase


def test_ready_on_cpu_target(fresh_probe):
    # The CPU target comes up at once (the plain versions).
    assert backend.backend_ready(timeout=30.0, device="cpu") is None
    # Cached: a second call with a tiny timeout is instant and still ok.
    assert backend.backend_ready(timeout=0.001) is None


def test_timeout_then_late_success(fresh_probe, monkeypatch):
    release = threading.Event()

    def slow_probe():
        release.wait(5.0)
        backend._result[0] = "ok"
        backend._done.set()

    monkeypatch.setattr(backend, "_probe", slow_probe)
    err = backend.backend_ready(timeout=0.05)
    assert err is not None and "did not complete" in err
    # The full bounded wait is charged once per process.
    t0 = time.monotonic()
    err2 = backend.backend_ready(timeout=30.0)
    assert err2 is not None and "still pending" in err2
    assert time.monotonic() - t0 < 1.0
    # The hung init eventually finishes: later calls see ready.
    release.set()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if backend.backend_ready(timeout=0.5) is None:
            break
    assert backend.backend_ready(timeout=0.5) is None


def test_init_failure_is_reported(fresh_probe, monkeypatch):
    def failing_probe():
        backend._result[0] = "backend init failed: no driver"
        backend._done.set()

    monkeypatch.setattr(backend, "_probe", failing_probe)
    assert backend.backend_ready(timeout=5.0) == \
        "backend init failed: no driver"


def test_failing_phase_names_its_error(fresh_probe, monkeypatch):
    def phase(ctx):
        raise RuntimeError("cuInit returned 999")

    monkeypatch.setattr(backend, "_phase_context_init", phase)
    err = backend.backend_ready(timeout=30.0, device="cpu")
    assert err == "backend init failed: cuInit returned 999"
    assert backend.probe_snapshot()["state"] == "failed"
    assert backend.probe_snapshot()["phase_reached"] == "driver_discovery"


def test_zero_timeout_disables_guard(fresh_probe, monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_BACKEND_INIT_TIMEOUT", "0")
    # Guard disabled: returns at once without starting a probe.
    assert backend.backend_ready() is None
    assert backend._started is False
    # The primary name wins over the alias.
    monkeypatch.setenv("MAKISU_TPU_PROBE_TIMEOUT", "7")
    assert backend.init_timeout() == 7.0


def test_wedge_verdict_shared_across_processes(fresh_probe, monkeypatch):
    """The first process to time out writes a verdict file; a second
    process (fresh probe state here) raises after only the short grace
    instead of paying its own full bounded wait."""
    monkeypatch.setattr(backend, "_probe", _hang_probe)
    err = backend.backend_ready(timeout=0.05)
    assert err is not None and "did not complete" in err

    monkeypatch.setenv("MAKISU_TPU_PROBE_GRACE", "0.05")
    _second_process()
    t0 = time.monotonic()
    err2 = backend.backend_ready(timeout=60.0)
    assert err2 is not None and "another process" in err2
    assert time.monotonic() - t0 < 1.0


def test_cached_wedge_grace_recovers_fixed_card(fresh_probe, monkeypatch):
    """A stale wedge verdict must not condemn a now-healthy card: a
    process whose own probe completes within the grace is ready despite
    another process's verdict."""
    monkeypatch.setattr(backend, "_probe", _hang_probe)
    assert backend.backend_ready(timeout=0.05) is not None
    assert backend._read_cached_wedge() is not None

    def quick_probe():
        backend._result[0] = "ok"
        backend._done.set()

    monkeypatch.setattr(backend, "_probe", quick_probe)
    monkeypatch.setenv("MAKISU_TPU_PROBE_GRACE", "2.0")
    _second_process()
    assert backend.backend_ready(timeout=60.0) is None


def test_cached_wedge_grace_charged_once_per_process(fresh_probe,
                                                     monkeypatch):
    """The grace wait is paid once per process, not once per layer."""
    monkeypatch.setattr(backend, "_probe", _hang_probe)
    assert backend.backend_ready(timeout=0.05) is not None

    monkeypatch.setenv("MAKISU_TPU_PROBE_GRACE", "0.3")
    _second_process()
    assert backend.backend_ready(timeout=60.0) is not None  # pays grace
    t0 = time.monotonic()
    for _ in range(10):
        assert backend.backend_ready(timeout=60.0) is not None
    assert time.monotonic() - t0 < 0.25  # 10 calls, no grace re-paid


def test_wedge_verdict_keyed_by_attachment_env(fresh_probe, monkeypatch):
    """Verdicts are keyed by the CUDA attachment variables: a process
    pointed at another card never inherits another attachment's
    wedge."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(backend, "_probe", _hang_probe)
    assert backend.backend_ready(timeout=0.05) is not None
    assert backend._read_cached_wedge() is not None
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert backend._read_cached_wedge() is None


def test_wedge_verdict_key_ignores_process_local_vars(fresh_probe,
                                                      monkeypatch):
    """Only the attachment variables key a verdict: a sibling process
    differing in per-process variables (its rank, its worker id) still
    inherits it, while another card re-keys it."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(backend, "_probe", _hang_probe)
    assert backend.backend_ready(timeout=0.05) is not None
    assert backend._read_cached_wedge() is not None
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("CUDA_LAUNCH_BLOCKING", "1")
    assert backend._read_cached_wedge() is not None
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2")
    assert backend._read_cached_wedge() is None


def test_wedge_verdict_ttl_expiry_reprobes(fresh_probe, monkeypatch):
    """An expired verdict is not hearsay any more: the next process pays
    its own bounded wait (the probe really restarts)."""
    monkeypatch.setattr(backend, "_probe", _hang_probe)
    assert backend.backend_ready(timeout=0.05) is not None

    monkeypatch.setenv("MAKISU_TPU_PROBE_CACHE_TTL", "0.001")
    time.sleep(0.01)
    _second_process()
    err = backend.backend_ready(timeout=0.05)
    assert err is not None and "did not complete" in err
    assert "another process" not in err  # own probe, not the cache
    assert backend._started is True      # the probe really restarted


def test_wedge_verdict_expires_and_clears(fresh_probe, monkeypatch):
    monkeypatch.setattr(backend, "_probe", _hang_probe)
    assert backend.backend_ready(timeout=0.05) is not None
    assert backend._read_cached_wedge() is not None
    # Expired verdicts are ignored...
    monkeypatch.setenv("MAKISU_TPU_PROBE_CACHE_TTL", "0.0001")
    time.sleep(0.01)
    assert backend._read_cached_wedge() is None
    monkeypatch.delenv("MAKISU_TPU_PROBE_CACHE_TTL")
    # ...a verdict for another target platform is ignored, and not
    # cleared by that target's success...
    backend._tracker.device = "cpu"
    assert backend._read_cached_wedge() is None
    backend._clear_cached_wedge()
    backend._tracker.device = "cuda"
    assert backend._read_cached_wedge() is not None
    # ...and a successful probe deletes the file for everyone.
    backend._clear_cached_wedge()
    assert backend._read_cached_wedge() is None


def test_warm_probe_prepays_the_wait(fresh_probe, monkeypatch):
    """A process that warmed the probe early (worker startup) charges
    later backend_ready() calls only the remainder of the budget."""
    release = threading.Event()

    def slow_probe():
        release.wait(5.0)
        backend._result[0] = "ok"
        backend._done.set()

    monkeypatch.setattr(backend, "_probe", slow_probe)
    backend.warm_probe(source="worker")
    time.sleep(0.3)
    release.set()
    time.sleep(0.1)
    t0 = time.monotonic()
    assert backend.backend_ready(timeout=30.0) is None
    assert time.monotonic() - t0 < 1.0
    assert backend.probe_snapshot()["source"] == "worker"


def test_warm_probe_remainder_budget(fresh_probe, monkeypatch):
    """With the probe warmed T seconds ago, a backend_ready(timeout)
    call waits at most (timeout - T), not a fresh full timeout."""
    monkeypatch.setattr(backend, "_probe", _hang_probe)
    backend.warm_probe()
    time.sleep(0.25)
    t0 = time.monotonic()
    err = backend.backend_ready(timeout=0.3)
    assert err is not None
    assert time.monotonic() - t0 < 0.2  # the ~0.05s remainder only


# -- no degrade: the device plane's users raise -------------------------------


def test_chunk_session_raises_on_wedged_backend(monkeypatch, card):
    """The reference degrades here (no fingerprints); the port raises the
    probe's summary, strict or not."""
    from makisu_tpu_torch.chunker.cdc import ChunkSession

    monkeypatch.delenv("MAKISU_TPU_CHUNK_STRICT", raising=False)
    monkeypatch.setattr(
        backend, "backend_ready",
        lambda timeout=None, source="build", device=None:
        "backend init did not complete within 180s")
    with pytest.raises(RuntimeError, match="did not complete"):
        ChunkSession()


def test_chunk_session_raises_on_wedged_phase(fresh_probe, monkeypatch,
                                              card):
    """A wedge in CUDA context creation (a patched phase): the session
    raises the probe's summary within the budget, before any launch and
    without running the plain versions."""
    from makisu_tpu_torch.chunker import cdc
    from makisu_tpu_torch.ops import gear, sha256

    monkeypatch.setenv("MAKISU_TPU_CHUNK_STRICT", "1")
    monkeypatch.setenv("MAKISU_TPU_PROBE_TIMEOUT", "0.3")
    monkeypatch.setattr(backend, "_phase_context_init",
                        _parked_context_init(fresh_probe))

    def never(*a, **k):
        raise AssertionError("a plain version ran")

    for mod, name in ((gear, "gear_bitmap"), (sha256, "sha256_spans"),
                      (sha256, "sha256_multi")):
        monkeypatch.setattr(mod, name, never)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not complete within 0.3s"):
        cdc.ChunkSession()
    assert time.monotonic() - t0 < 2.0
    snap = backend.probe_snapshot()
    assert snap["state"] == "wedged" and snap["phase"] == "context_init"
    assert snap["phase_reached"] == "driver_discovery"


def test_chunk_session_raises_on_failed_phase(fresh_probe, monkeypatch,
                                              card):
    from makisu_tpu_torch.chunker import cdc

    def phase(ctx):
        raise RuntimeError("NVIDIA A100 is sm_80, not a Hopper card")

    monkeypatch.setattr(backend, "_phase_device_enumeration", phase)
    monkeypatch.setattr(backend, "_phase_context_init", lambda ctx: None)
    with pytest.raises(RuntimeError,
                       match="backend init failed: NVIDIA A100 is sm_80"):
        cdc.ChunkSession()


def test_second_process_raises_within_the_grace(fresh_probe, monkeypatch,
                                                card):
    """A second process with a fresh wedge verdict raises within the
    grace, not after the full timeout."""
    from makisu_tpu_torch.chunker import cdc

    monkeypatch.setattr(backend, "_phase_context_init",
                        _parked_context_init(fresh_probe))
    monkeypatch.setenv("MAKISU_TPU_PROBE_TIMEOUT", "0.2")
    with pytest.raises(RuntimeError, match="did not complete"):
        cdc.ChunkSession()
    monkeypatch.setenv("MAKISU_TPU_PROBE_TIMEOUT", "60")
    monkeypatch.setenv("MAKISU_TPU_PROBE_GRACE", "0.3")
    _second_process()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="in another process"):
        cdc.ChunkSession()
    assert time.monotonic() - t0 < 1.5


def test_hash_service_and_snapshot_hasher_raise_on_wedge(monkeypatch,
                                                         card):
    from makisu_tpu_torch.chunker.service import HashService
    from makisu_tpu_torch.models.snapshot_hasher import SnapshotHasher

    monkeypatch.setattr(
        backend, "backend_ready",
        lambda timeout=None, source="build", device=None:
        "backend init did not complete within 180s (card wedged?)")
    with pytest.raises(RuntimeError, match="card wedged"):
        HashService()
    with pytest.raises(RuntimeError, match="card wedged"):
        SnapshotHasher()


# -- sync_bounded --------------------------------------------------------------


class _Event:
    """A stand-in CUDA event: done ``after`` seconds from now (never when
    None), or raising ``error`` when asked."""

    def __init__(self, after=0.0, error=None):
        self.ready_at = None if after is None else time.monotonic() + after
        self.error = error
        self.queries = 0
        self.synchronized = False

    def query(self):
        self.queries += 1
        if self.error is not None:
            raise self.error
        return self.ready_at is not None and \
            time.monotonic() >= self.ready_at

    def synchronize(self):
        self.synchronized = True


def test_sync_bounded_passthrough_and_timeout():
    done = _Event(after=0.05)
    backend.sync_bounded(done, "t")
    assert done.queries >= 2  # polled, not synchronized
    backend.sync_bounded(None, "nothing to wait for")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError,
                       match="gear bitmap readback did not complete "
                             "within 0.1s"):
        backend.sync_bounded(_Event(after=None), "gear bitmap readback",
                             timeout=0.1)
    assert time.monotonic() - t0 < 0.5


def test_sync_bounded_propagates_errors():
    with pytest.raises(RuntimeError, match="device died"):
        backend.sync_bounded(_Event(error=RuntimeError("device died")),
                             "t", timeout=5.0)


def test_sync_timeout_env_and_zero_waits_natively(monkeypatch):
    monkeypatch.delenv("MAKISU_TPU_SYNC_TIMEOUT", raising=False)
    assert backend.sync_timeout() == 300.0
    monkeypatch.setenv("MAKISU_TPU_SYNC_TIMEOUT", "0")
    done = _Event(after=None)
    backend.sync_bounded(done, "t")  # the bound off: one native wait
    assert done.synchronized and done.queries == 0


def test_sync_bounded_exports_seconds_and_results():
    from makisu_tpu_torch.utils import metrics
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        backend.sync_bounded(_Event(), "t")
        with pytest.raises(TimeoutError):
            backend.sync_bounded(_Event(after=None), "t", timeout=0.01)
        with pytest.raises(ValueError):
            backend.sync_bounded(_Event(error=ValueError("x")), "t")
    finally:
        metrics.reset_build_registry(token)
    for result in ("ok", "timeout", "error"):
        assert reg.counter_total("makisu_device_sync_total",
                                 result=result) == 1
    hist = reg.report()["histograms"]["makisu_device_sync_seconds"]
    assert sum(h["count"] for h in hist) == 3


def test_chunk_session_raises_on_readback_hang(monkeypatch):
    """A bitmap that never comes back: the session raises TimeoutError
    naming the wait within the bounded window (the reference degrades),
    and never falls back."""
    from makisu_tpu_torch.chunker import cdc

    monkeypatch.setenv("MAKISU_TPU_SYNC_TIMEOUT", "0.2")

    class HangingBlock(cdc._HostBlock):
        def __init__(self, *a):
            super().__init__(*a)
            self.done = _Event(after=None)

    monkeypatch.setattr(cdc, "_HostBlock", HangingBlock)
    s = cdc.ChunkSession(block=64 * 1024, device="cpu")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="gear bitmap readback"):
        s.update(np.full(256 * 1024, ord("y"), np.uint8).tobytes())
    assert time.monotonic() - t0 < 2.0
