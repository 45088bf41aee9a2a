"""The port's device-plane observability: the phase-resolved probe, the
stack-sample trajectory, the ``makisu-tpu.deviceprobe.v1`` session
ledger (``makisu_tpu_torch/utils/deviceprobe.py``), ``doctor --device``,
the probe in bundles and on a worker's ``/healthz`` and SLO page — held
against the JAX package on the same records.

Every case of the reference's ``tests/test_deviceprobe.py`` with a
counterpart, on the port. A wedge is a monkeypatched phase parked on an
event, as the reference's is; the port's phases are
``backend.PROBE_PHASES`` (its wedge point is ``context_init``, CUDA
context creation). The healthy path runs the probe on its CPU target
(``device="cpu"``: the plain versions). Two reference cases have no
counterpart: ``test_bench_parent_wedge_record`` (the port has no bench
harness whose parent writes records for a frozen child) and
``test_lane_batcher_exports_dispatch_telemetry`` (the ring replaced the
lane batcher; the ring's dispatch telemetry is tested in
``test_torch_metrics.py``).
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from makisu_tpu.ops import backend as ref_backend
from makisu_tpu.utils import deviceprobe as ref_deviceprobe
from makisu_tpu_torch.ops import backend
from makisu_tpu_torch.utils import deviceprobe, events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset(mod, monkeypatch):
    monkeypatch.setattr(mod, "_done", threading.Event())
    monkeypatch.setattr(mod, "_result", [None])
    monkeypatch.setattr(mod, "_started", False)
    monkeypatch.setattr(mod, "_probe_start", 0.0)
    monkeypatch.setattr(mod, "_timed_out", False)
    monkeypatch.setattr(mod, "_grace_spent", False)
    monkeypatch.setattr(mod, "_tracker", mod._ProbeTracker())


@pytest.fixture
def fresh_probe(monkeypatch):
    """Fresh probe state; yields the event that releases a parked phase,
    and joins the probe thread while this test's state is current."""
    from makisu_tpu_torch.ops import sha256_cuda
    _reset(backend, monkeypatch)
    # Each probe holds S1 against hashlib again (once per process).
    monkeypatch.setattr(sha256_cuda, "_probed", set())
    release = threading.Event()
    yield release
    release.set()
    for t in threading.enumerate():
        if t.name in ("cuda-backend-probe", "jax-backend-probe"):
            t.join(timeout=15)


def _wait_for(predicate, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(0.02)
    return predicate()


def _wedge_in_native_call(release: threading.Event) -> None:
    """Stand-in for a wedge inside a C call (context creation on a card
    that dropped off the bus): no Python line ever raises. The function
    NAME is the assertion target: the stack sampler must surface it."""
    release.wait(30.0)


def _hanging_context_init(release: threading.Event):
    def phase(ctx):
        _wedge_in_native_call(release)
    return phase


def _wedge(monkeypatch, release, sessions=None, timeout="0.5"):
    if sessions is not None:
        monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", str(sessions))
    monkeypatch.setenv("MAKISU_TPU_PROBE_SAMPLE_INTERVAL", "0.02")
    monkeypatch.setenv("MAKISU_TPU_PROBE_TIMEOUT", timeout)
    monkeypatch.setattr(backend, "_phase_context_init",
                        _hanging_context_init(release))


# -- the wedge golden path --------------------------------------------------


def test_simulated_wedge_produces_ledger_record(fresh_probe, monkeypatch,
                                                tmp_path):
    """A device-plane wedge yields a deviceprobe.v1 record naming the
    wedged phase with >=3 stack samples, and doctor --device renders a
    diagnosis from it."""
    sessions = tmp_path / "sessions"
    _wedge(monkeypatch, fresh_probe, sessions)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    err = backend.backend_ready(source="worker", device="cpu")
    assert err is not None and "did not complete" in err

    records = _wait_for(lambda: deviceprobe.read_records(str(sessions)))
    assert records, "wedge never produced a ledger record"
    rec = records[-1]
    assert rec["schema"] == "makisu-tpu.deviceprobe.v1"
    assert rec["verdict"] == "wedged"
    assert rec["source"] == "worker"
    assert rec["wedged_phase"] == "context_init"
    done_phases = {p["phase"] for p in rec["phases"] if p["ok"]}
    assert "driver_discovery" in done_phases
    assert rec["phase_reached"] == "driver_discovery"
    assert rec["samples"]
    assert sum(s["count"] for s in rec["samples"]) >= 3
    assert any("_wedge_in_native_call" in s["frame"]
               for s in rec["samples"])
    # The attachment: hashed key, the CUDA variable names present.
    assert len(rec["attachment"]["key"]) == 32
    assert rec["attachment"]["vars"] == ["CUDA_VISIBLE_DEVICES"]

    snap = backend.probe_snapshot()
    assert snap["state"] == "wedged"
    assert snap["phase"] == "context_init"
    assert snap["sample_count"] >= 3
    assert "_wedge_in_native_call" in snap["deepest_frame"]

    out = deviceprobe.render_device_doctor(records)
    assert "dominant wedge: phase 'context_init'" in out
    assert "_wedge_in_native_call" in out
    assert "identical samples" in out
    assert "diagnosis: backend init wedges in 'context_init'" in out


def test_doctor_device_cli_renders_wedge(fresh_probe, monkeypatch,
                                         tmp_path, capsys):
    sessions = tmp_path / "sessions"
    _wedge(monkeypatch, fresh_probe, sessions, timeout="0.4")
    assert backend.backend_ready(device="cpu") is not None
    assert _wait_for(lambda: deviceprobe.read_records(str(sessions)))
    from makisu_tpu_torch import cli
    assert cli.main(["doctor", "--device", str(sessions)]) == 0
    out = capsys.readouterr().out
    assert "device route" in out
    assert "context_init" in out


def test_doctor_device_cli_errors_on_empty(monkeypatch, tmp_path):
    from makisu_tpu_torch import cli
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR",
                       str(tmp_path / "empty"))
    with pytest.raises(SystemExit, match="no makisu-tpu.deviceprobe"):
        cli.main(["doctor", "--device"])
    with pytest.raises(SystemExit, match="bundle path"):
        cli.main(["doctor"])


def test_doctor_device_without_records_says_what_the_reference_says(
        monkeypatch, tmp_path):
    from makisu_tpu import cli as ref_cli
    from makisu_tpu_torch import cli
    where = str(tmp_path / "none")
    messages = []
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["doctor", "--device", where])
        messages.append(str(exc.value.code))
    assert messages[0] == messages[1]
    assert messages[0].startswith(f"no makisu-tpu.deviceprobe.v1 records "
                                  f"found in {where};")


# -- the healthy path -------------------------------------------------------


def test_healthy_probe_records_ok_with_phase_timings(fresh_probe,
                                                     monkeypatch,
                                                     tmp_path):
    """On the CPU target every phase completes: the ledger record
    carries all five phase timings and verdict ok."""
    sessions = tmp_path / "sessions"
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", str(sessions))
    assert backend.backend_ready(timeout=120.0, device="cpu") is None
    assert backend.wait_for_probe_record(20.0)
    records = deviceprobe.read_records(str(sessions))
    assert records
    rec = records[-1]
    assert rec["verdict"] == "ok"
    assert rec["platform"] == "cpu"
    assert rec["wedged_phase"] == ""
    assert rec["phase_reached"] == "first_dispatch"
    assert [p["phase"] for p in rec["phases"]] == list(backend.PROBE_PHASES)
    assert all(p["ok"] for p in rec["phases"])
    assert all(p["seconds"] >= 0 for p in rec["phases"])

    snap = backend.probe_snapshot()
    assert snap["state"] == "ok"
    assert backend.probe_label() == "ok"

    out = deviceprobe.render_device_doctor(records)
    assert "healthy" in out
    assert "first_dispatch" not in out.split("diagnosis:")[1]


def test_probe_phase_events_on_event_bus(fresh_probe, monkeypatch):
    """Each phase emits start/done heartbeats on the event bus, in
    execution order; the parity probe inside first_dispatch reports
    too."""
    seen: list[dict] = []
    events.add_global_sink(seen.append)
    try:
        assert backend.backend_ready(timeout=120.0, device="cpu") is None
    finally:
        events.remove_global_sink(seen.append)
    phases = [(e.get("phase"), e.get("status")) for e in seen
              if e.get("type") == "device_probe"]
    for name in backend.PROBE_PHASES:
        assert (name, "start") in phases
        assert (name, "done") in phases
    starts = [p for p, s in phases if s == "start"]
    assert starts == list(backend.PROBE_PHASES)
    assert ("sha_parity_probe", "done") in phases


def test_probe_snapshot_absent_and_disabled(fresh_probe, monkeypatch):
    assert backend.probe_snapshot()["state"] == "absent"
    assert backend.probe_label() == "absent"
    monkeypatch.setenv("MAKISU_TPU_PROBE_TIMEOUT", "0")
    assert backend.probe_snapshot()["state"] == "disabled"


def test_recording_gated_on_the_card_target(fresh_probe, monkeypatch):
    """With no explicit sessions dir, only a probe whose target is the
    card records (CPU test runs never write into the checkout); an
    explicit env var always decides."""
    monkeypatch.delenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", raising=False)
    backend._tracker.device = "cpu"
    assert backend._recording_wanted() is False
    backend._tracker.device = "cuda"
    assert backend._recording_wanted() is True
    backend._tracker.device = "cuda:1"
    assert backend._recording_wanted() is True
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", "")
    assert backend._recording_wanted() is False
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", "/tmp/x")
    backend._tracker.device = "cpu"
    assert backend._recording_wanted() is True


def test_default_ledger_is_under_build(monkeypatch):
    """Unset, the ledger goes to build/device_sessions in the checkout
    (ignored by git), never under benchmarks/."""
    monkeypatch.delenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", raising=False)
    assert deviceprobe.sessions_dir() == os.path.join(
        ROOT, "build", "device_sessions")
    assert deviceprobe.ledger_path() == os.path.join(
        ROOT, "build", "device_sessions", "device_probes.jsonl")


def test_record_names_the_cuda_attachment(fresh_probe, monkeypatch,
                                          tmp_path):
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", str(tmp_path))
    for var in backend.ATTACHMENT_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    monkeypatch.setenv("RANK", "1")  # not an attachment variable
    backend._tracker.source = "worker"
    backend._record_attempt(backend._tracker, "ok", "", 180.0,
                            time.monotonic())
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    backend._record_attempt(backend._tracker, "ok", "", 180.0,
                            time.monotonic())
    a, b = deviceprobe.read_records(str(tmp_path))
    assert a["platform"] == "cuda" and a["source"] == "worker"
    assert a["attachment"]["vars"] == ["CUDA_DEVICE_ORDER",
                                       "CUDA_VISIBLE_DEVICES"]
    assert a["attachment"]["key"] != b["attachment"]["key"]
    assert "PCI_BUS_ID" not in json.dumps(a)  # values stay hashed


# -- ledger + doctor units --------------------------------------------------


def _record(ts, verdict, phase="context_init", source="build",
            key="a" * 32, frame="cuInit (backend.py:123)", count=12):
    rec = {
        "schema": deviceprobe.SCHEMA, "ts": ts, "pid": 1,
        "source": source, "platform": "cuda",
        "attachment": {"key": key, "vars": ["CUDA_VISIBLE_DEVICES"]},
        "verdict": verdict, "detail": "", "timeout_seconds": 180,
        "total_seconds": 180.0 if verdict == "wedged" else 3.0,
        "phase_reached": ("first_dispatch" if verdict == "ok"
                          else "driver_discovery"),
        "wedged_phase": phase if verdict == "wedged" else "",
        "phases": [{"phase": "driver_discovery", "seconds": 0.2,
                    "ok": True}],
        "samples": ([{"frame": frame, "count": count,
                      "stack": [frame, "init (__init__.py:50)"]}]
                    if verdict == "wedged" else []),
    }
    if verdict == "ok":
        rec["phases"] = [{"phase": p, "seconds": 1.0, "ok": True}
                         for p in backend.PROBE_PHASES]
    if verdict == "failed":
        rec["detail"] = "backend init failed: CUDA is not available"
    return rec


_HISTORY = [
    _record(100.0, "ok"),
    _record(200.0, "ok", source="worker"),
    _record(300.0, "wedged"),
    _record(400.0, "wedged", source="worker"),
    _record(450.0, "failed"),
    _record(500.0, "wedged", key="b" * 32),
]


def test_render_device_doctor_cross_session():
    records = [r for r in _HISTORY if r["verdict"] != "failed"]
    out = deviceprobe.render_device_doctor(records)
    assert "5 probe attempts" in out
    assert "ok×2" in out and "wedged×3" in out
    assert "dominant wedge: phase 'context_init' (3 of 3" in out
    assert "cuInit" in out
    assert "via init" in out
    assert "12 identical samples" in out
    assert "last healthy:" in out
    assert "SINCE the last healthy init" in out
    assert "aaaaaaaaaaaa…" in out and "bbbbbbbbbbbb…" in out
    assert "healthy-path phase p50" in out


def test_ledger_append_read_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR",
                       str(tmp_path / "s"))
    path = deviceprobe.append_record(_record(1.0, "wedged"))
    assert path is not None
    deviceprobe.append_record(_record(2.0, "ok"))
    records = deviceprobe.read_records()
    assert [r["verdict"] for r in records] == ["wedged", "ok"]
    assert len(deviceprobe.read_records(path)) == 2
    digest = deviceprobe.tail(limit=1)
    assert digest["records"] == 2
    assert digest["verdicts"] == {"ok": 1, "wedged": 1}
    assert digest["tail"][0]["verdict"] == "ok"


def test_ledger_disabled_is_noop(monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", "")
    assert deviceprobe.sessions_dir() is None
    assert deviceprobe.append_record(_record(1.0, "ok")) is None
    assert deviceprobe.read_records() == []


# -- against the reference: one ledger, one text ----------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_renders_the_others_ledger(writer, tmp_path,
                                                monkeypatch):
    """One package's append_record, the other's read_records: the same
    records, the same doctor text and the same digest, both ways."""
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", str(tmp_path))
    write = (deviceprobe if writer == "port" else ref_deviceprobe)
    for rec in _HISTORY:
        write.append_record(rec)
    ours = deviceprobe.read_records(str(tmp_path))
    theirs = ref_deviceprobe.read_records(str(tmp_path))
    assert ours == theirs == sorted(_HISTORY, key=lambda r: r["ts"])
    assert deviceprobe.render_device_doctor(ours) == \
        ref_deviceprobe.render_device_doctor(theirs)
    assert deviceprobe.tail(path=str(tmp_path)) == \
        ref_deviceprobe.tail(path=str(tmp_path))


def test_doctor_device_cli_matches_reference_render(fresh_probe,
                                                    monkeypatch, tmp_path,
                                                    capsys):
    """The port's ``doctor --device`` on a ledger the reference wrote,
    plus a real wedge record of the port's probe: byte for byte the
    reference's render_device_doctor of the same records."""
    sessions = tmp_path / "sessions"
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", str(sessions))
    for rec in _HISTORY:
        ref_deviceprobe.append_record(rec)
    _wedge(monkeypatch, fresh_probe, timeout="0.3")
    assert backend.backend_ready(device="cpu") is not None
    assert _wait_for(lambda: len(deviceprobe.read_records(
        str(sessions))) == len(_HISTORY) + 1)
    from makisu_tpu_torch import cli
    assert cli.main(["doctor", "--device", str(sessions)]) == 0
    out = capsys.readouterr().out
    want = ref_deviceprobe.render_device_doctor(
        ref_deviceprobe.read_records(str(sessions)))
    assert out == want
    assert "7 probe attempts" in out


@pytest.mark.parametrize("state", ["absent", "wedged", "ok"])
def test_probe_snapshot_keys_are_the_reference_s(state, fresh_probe,
                                                 monkeypatch):
    _reset(ref_backend, monkeypatch)
    monkeypatch.setenv("MAKISU_TPU_PROBE_SAMPLE_INTERVAL", "0.02")
    if state == "wedged":
        monkeypatch.setenv("MAKISU_TPU_PROBE_TIMEOUT", "0.2")
        monkeypatch.setattr(backend, "_phase_context_init",
                            _hanging_context_init(fresh_probe))

        def ref_phase(ctx):
            _wedge_in_native_call(fresh_probe)
        monkeypatch.setattr(ref_backend, "_phase_client_init", ref_phase)
    if state != "absent":
        backend.backend_ready(device="cpu")
        ref_backend.backend_ready()
        # A wedge: both watchers have sampled and written the verdict.
        _wait_for(lambda: all(m.probe_snapshot()["sample_count"]
                              and m.probe_snapshot().get("detail")
                              for m in (backend, ref_backend))
                  if state == "wedged" else True)
    ours, theirs = backend.probe_snapshot(), ref_backend.probe_snapshot()
    assert ours["state"] == theirs["state"] == state
    # deepest_frame is there once a sample was taken (a probe can end
    # before the first), as in the reference.
    optional = {"deepest_frame"} if state == "ok" else set()
    assert set(ours) - optional == set(theirs) - optional
    assert set(ours) <= set(theirs) | {"deepest_frame"}
    assert set(backend.device_health()["probe"]) <= \
        set(ref_backend.device_health()["probe"]) | {"sample_count"}


# -- the worker's surfaces ---------------------------------------------------


@pytest.mark.parametrize("state", ["absent", "disabled", "pending", "ok",
                                   "failed", "wedged", "error"])
def test_workers_page_the_same_probe_states(state, tmp_path, monkeypatch):
    """Both workers' SLO sample gives the same ``device_probe_bad`` for
    each probe state (1.0 on wedged, failed, or a device plane that
    cannot answer)."""
    from makisu_tpu.worker import WorkerServer as RefServer
    from makisu_tpu_torch.worker import WorkerServer
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")

    def health():
        if state == "error":
            raise RuntimeError("device plane gone")
        return {"probe": {"state": state, "sample_count": 0}}

    monkeypatch.setattr(backend, "device_health", health)
    monkeypatch.setattr(ref_backend, "device_health", health)
    bad = []
    for cls, sock in ((WorkerServer, "port.sock"),
                      (RefServer, "ref.sock")):
        kw = {"device": "cpu"} if cls is WorkerServer else {}
        server = cls(str(tmp_path / sock), **kw)
        try:
            bad.append(server._slo_probe()["levels"]["device_probe_bad"])
        finally:
            server.server_close()
            server.session_mgr.reset()
    assert bad[0] == bad[1] == (
        1.0 if state in ("wedged", "failed", "error") else 0.0)


def test_wedged_worker_pages_device_probe(fresh_probe, monkeypatch,
                                          tmp_path):
    """A worker whose startup probe wedges still answers /healthz, whose
    device section names the phase, and the ``device_probe`` page rule
    fires."""
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")
    monkeypatch.setenv("MAKISU_TPU_WORKER_WARM_PROBE", "1")
    _wedge(monkeypatch, fresh_probe, timeout="0.3")
    server = WorkerServer(str(tmp_path / "w.sock"), slo_interval=0,
                          device="cpu")
    thread = server.serve_background()
    try:
        client = WorkerClient(server.socket_path)
        probe = _wait_for(lambda: (lambda p: p if p["state"] == "wedged"
                                   and p.get("sample_count") else None)(
            client.healthz()["device"]["probe"]))
        assert probe["phase"] == "context_init"
        assert probe["phase_reached"] == "driver_discovery"
        assert probe["source"] == "worker"
        assert probe["elapsed_seconds"] >= 0.3
        assert server._slo_probe()["levels"]["device_probe_bad"] == 1.0
        server.slo.tick()
        assert "device_probe" in {a["rule"]
                                  for a in client.alerts()["active"]}
        assert client.healthz()["alerts"]["page"] >= 1
    finally:
        server.shutdown()
        server.server_close()
        server.session_mgr.reset()
        thread.join(timeout=5)


# -- flight-recorder integration -------------------------------------------


def test_bundle_carries_probe_and_doctor_renders_it(fresh_probe,
                                                    monkeypatch):
    _wedge(monkeypatch, fresh_probe, timeout="0.3")
    assert backend.backend_ready(device="cpu") is not None
    _wait_for(lambda: backend.probe_snapshot()["sample_count"] >= 1)
    from makisu_tpu_torch.utils import flightrecorder
    bundle = flightrecorder.FlightRecorder().bundle("stall")
    probe = bundle["device_probe"]
    assert probe["state"] == "wedged"
    assert probe["phase"] == "context_init"
    assert probe["samples"] and probe["sample_count"] >= 1
    rendered = flightrecorder.render_doctor(bundle)
    assert "device probe: wedged, in phase 'context_init'" in rendered
    assert "backend init wedged in probe phase" in rendered
    # The reference's doctor renders the port's bundle the same way.
    from makisu_tpu.utils import flightrecorder as ref_flightrecorder
    ref_rendered = ref_flightrecorder.render_doctor(bundle)
    assert "device probe: wedged, in phase 'context_init'" in ref_rendered


def test_history_records_the_probe_label(fresh_probe, monkeypatch):
    from makisu_tpu_torch.utils import history
    assert history.probe_label() == "absent"
    _wedge(monkeypatch, fresh_probe, timeout="0.2")
    assert backend.backend_ready(device="cpu") is not None
    assert history.probe_label() == "wedged"
    rec = history.record_from_report({"command": "build", "exit_code": 1},
                                     command="build")
    assert rec["device_probe"] == "wedged"


_NO_TORCH = """
import sys
from makisu_tpu_torch import cli
from makisu_tpu_torch.utils import deviceprobe
assert cli.main(["doctor", "--device", sys.argv[1]]) == 0
assert "torch" not in sys.modules, "torch imported"
print("clean")
"""


def test_doctor_device_and_deviceprobe_import_no_torch(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_DEVICE_SESSIONS_DIR", str(tmp_path))
    for rec in _HISTORY:
        deviceprobe.append_record(rec)
    out = subprocess.run([sys.executable, "-c", _NO_TORCH, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
    assert "dominant wedge: phase 'context_init'" in out.stdout
