"""Failure forensics, profiling, resource sampling and build history of
the port: the cases of the reference's tests/test_flightrecorder.py,
test_profiler.py, test_resources.py and test_history.py, run against
makisu_tpu_torch on the CPU (builds pass ``device="cpu"``; the port's
counterpart of ``--hasher tpu`` is ``--hasher gpu``).

The stall watchdog's windows are at least 1 s and every wait has a
deadline of at least 20 s, so a loaded 6-worker run cannot starve them.
The reference's worker cases have standalone counterparts: the port has
no worker yet, and its long-lived process is ``build --watch``."""

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from makisu_tpu_torch import cli
from makisu_tpu_torch.utils import (
    events,
    flightrecorder,
    history,
    metrics,
    profiler,
    resources,
    traceexport,
)
from makisu_tpu_torch.utils import logging as log

# The stall watchdog's window, and the longest any wait may take.
WINDOW = 1.0
DEADLINE = 20.0


# -- flight recorder, stall watchdog, doctor ----------------------------

BUNDLE_KEYS = {"schema", "reason", "ts", "build", "last_progress_seconds",
               "events", "logs", "open_spans", "threads", "transfer",
               "resources", "metrics"}


def _wedged_transfer_wait(release: threading.Event) -> None:
    """Stands in for a transfer thread stuck on a dead registry; the
    bundle's thread stacks must name this frame."""
    release.wait(timeout=30)


@pytest.fixture(autouse=True)
def _close_sessions():
    """The builds' resident sessions (both packages' process-wide
    managers) close after each test, releasing their inotify instances:
    a per-user budget of 128 that every test process shares."""
    yield
    from makisu_tpu.worker import session as ref_session_mod
    from makisu_tpu_torch.worker import session as session_mod
    session_mod.manager().reset()
    ref_session_mod.manager().reset()


@pytest.fixture
def wedged_bundle(tmp_path):
    """Run the wedged-fake-build scenario once: a build with an open
    span chain (one completed child), a wedged worker thread, and a
    stall watchdog with a tiny window. Yields (bundle dict, path)."""
    bundle_path = str(tmp_path / "bundle.json")
    registry = metrics.MetricsRegistry()
    reg_token = metrics.set_build_registry(registry)
    recorder = flightrecorder.FlightRecorder()
    tokens = flightrecorder.install(recorder)
    release = threading.Event()
    wedged = threading.Thread(target=_wedged_transfer_wait,
                              args=(release,), name="transfer-blob-w0")
    wedged.start()
    watchdog = None
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(metrics.span("build"))
            with metrics.span("commit_layer"):  # a COMPLETED span
                time.sleep(0.02)
            stack.enter_context(metrics.span("step", directive="RUN"))
            log.info("about to wedge the fake build")
            watchdog = flightrecorder.StallWatchdog(
                WINDOW, recorder, bundle_path, registry).start()
            deadline = time.monotonic() + DEADLINE
            while (not os.path.exists(bundle_path)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
    finally:
        if watchdog is not None:
            watchdog.stop()
        release.set()
        wedged.join(timeout=5)
        flightrecorder.uninstall(tokens)
        metrics.reset_build_registry(reg_token)
    assert os.path.exists(bundle_path), "watchdog never dumped a bundle"
    with open(bundle_path, encoding="utf-8") as f:
        return json.load(f), bundle_path


def test_wedged_build_bundle_golden_shape(wedged_bundle):
    bundle, _path = wedged_bundle
    # Golden shape: every section present, schema/reason right.
    assert bundle["schema"] == "makisu-tpu.flightrecorder.v1"
    assert bundle["reason"] == "stall"
    assert BUNDLE_KEYS <= set(bundle)
    assert bundle["last_progress_seconds"] >= WINDOW

    # The stuck span chain: build -> step, step is the open LEAF with
    # an age at least the watchdog window; commit_layer closed and so
    # must NOT appear.
    open_names = {s["name"] for s in bundle["open_spans"]}
    assert {"build", "step"} <= open_names
    assert "commit_layer" not in open_names
    step = next(s for s in bundle["open_spans"] if s["name"] == "step")
    build = next(s for s in bundle["open_spans"] if s["name"] == "build")
    assert step["leaf"] and not build["leaf"]
    assert step["age_seconds"] >= WINDOW
    assert step["attrs"] == {"directive": "RUN"}
    assert step["parent_id"] == build["span_id"]

    # The stall event was fired into the build's own sinks and is the
    # ring's last event (span/log records precede it).
    stall_events = [e for e in bundle["events"] if e["type"] == "stall"]
    assert len(stall_events) == 1
    assert stall_events[0]["idle_seconds"] >= WINDOW
    assert stall_events[0]["window_seconds"] == WINDOW
    assert bundle["events"][-1]["type"] == "stall"
    assert any(e["type"] == "span_start" for e in bundle["events"])

    # All-thread stacks name the wedged thread and its stuck frame.
    by_name = {t["name"]: t for t in bundle["threads"]}
    assert "transfer-blob-w0" in by_name
    assert any("_wedged_transfer_wait" in frame
               for frame in by_name["transfer-blob-w0"]["stack"])
    assert "MainThread" in by_name

    # Log ring captured the pre-wedge record; metrics snapshot is the
    # build registry's (trace ids match).
    assert any("about to wedge" in r["msg"] for r in bundle["logs"])
    assert bundle["metrics"]["schema"] == "makisu-tpu.metrics.v1"
    assert bundle["metrics"]["trace_id"] == bundle["build"]["trace_id"]


def test_doctor_renders_diagnosis(wedged_bundle, capsys):
    bundle, path = wedged_bundle
    text = flightrecorder.render_doctor(bundle)
    assert "reason: stall" in text
    assert "stuck" in text and "'step'" in text  # the stuck leaf span
    assert "transfer-blob-w0" in text            # the wedged thread
    assert "stall" in text                       # the event tail
    # Round-trip through the CLI subcommand.
    assert cli.main(["doctor", path]) == 0
    out = capsys.readouterr().out
    assert "makisu-tpu doctor" in out
    assert "'step'" in out


def test_doctor_rejects_non_bundle(tmp_path):
    bogus = tmp_path / "not-a-bundle.json"
    bogus.write_text('{"hello": "world"}')
    with pytest.raises(SystemExit, match="not a makisu-tpu diagnostic"):
        cli.main(["doctor", str(bogus)])


def test_report_on_bundle_marks_open_spans(wedged_bundle, capsys):
    """`makisu-tpu report` pointed at a bundle of a build that died
    mid-flight: completed spans still get phase self-times; open ones
    are listed and marked."""
    _bundle, path = wedged_bundle
    assert cli.main(["report", path]) == 0
    out = capsys.readouterr().out
    assert "build died mid-flight" in out
    assert "spans still open at capture" in out
    assert "✱ open" in out
    assert "step" in out
    # The completed commit_layer span contributes hash-phase self time.
    assert "commit_layer" in out
    hash_part = out.split("hash=")[1]
    assert float(hash_part.split("s")[0]) > 0


def test_watchdog_does_not_fire_while_progressing(tmp_path):
    bundle_path = tmp_path / "no-bundle.json"
    recorder = flightrecorder.FlightRecorder()
    watchdog = flightrecorder.StallWatchdog(
        WINDOW, recorder, str(bundle_path)).start()
    try:
        for _ in range(30):
            events.emit("step", phase="tick")
            time.sleep(0.1)
    finally:
        watchdog.stop()
    assert not bundle_path.exists()
    assert not recorder.dumped


def test_permanent_wedge_fires_once_and_clock_climbs(tmp_path):
    """The watchdog's own stall emit and warning log must not count as
    progress: a permanent wedge produces exactly ONE stall event, and
    the progress clock (what /healthz reports) keeps climbing past the
    window instead of being reset by the forensics."""
    bundle_path = str(tmp_path / "once.json")
    recorder = flightrecorder.FlightRecorder()
    tokens = flightrecorder.install(recorder)
    watchdog = None
    try:
        events.emit("last_real_progress")
        watchdog = flightrecorder.StallWatchdog(
            WINDOW, recorder, bundle_path).start()
        deadline = time.monotonic() + DEADLINE
        while (not os.path.exists(bundle_path)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(2 * WINDOW)  # two more windows with no progress
        stalls = [e for e in recorder._snapshot(recorder._events)
                  if e["type"] == "stall"]
        assert len(stalls) == 1
        assert flightrecorder.last_progress_seconds() >= 2 * WINDOW
    finally:
        if watchdog is not None:
            watchdog.stop()
        flightrecorder.uninstall(tokens)


def test_per_build_bundle_excludes_other_builds_spans():
    """A per-build bundle filters the process-wide open-span set to
    its own trace — in a worker, build B's bundle must not blame a
    healthy build A's long-running span."""
    reg_a = metrics.MetricsRegistry()
    reg_b = metrics.MetricsRegistry()
    recorder = flightrecorder.FlightRecorder()
    token_a = metrics.set_build_registry(reg_a)
    try:
        with metrics.span("build_a_stage"):
            token_b = metrics.set_build_registry(reg_b)
            try:
                with metrics.span("build_b_step"):
                    bundle_b = recorder.bundle("failure", reg_b)
                    process_bundle = recorder.bundle(
                        "inspect", metrics.global_registry())
            finally:
                metrics.reset_build_registry(token_b)
    finally:
        metrics.reset_build_registry(token_a)
    names_b = {s["name"] for s in bundle_b["open_spans"]}
    assert names_b == {"build_b_step"}
    # The process-level view (worker SIGTERM bundle) keeps everything.
    names_all = {s["name"] for s in process_bundle["open_spans"]}
    assert {"build_a_stage", "build_b_step"} <= names_all


def test_per_build_watchdog_not_masked_by_sibling_progress(tmp_path):
    """A per-build watchdog watches ITS build's progress cell: a
    healthy sibling build stamping the process clock (bare thread, no
    cell) must not mask the wedged build's stall."""
    bundle_path = tmp_path / "masked.json"
    recorder = flightrecorder.FlightRecorder()
    cell_token = events.bind_progress_cell()
    stop_sibling = threading.Event()

    def sibling():
        # No progress cell in this thread's context: stamps only the
        # process-wide clock, like another build would.
        while not stop_sibling.wait(0.05):
            events.emit("sibling_step")

    noisy = threading.Thread(target=sibling)
    noisy.start()
    watchdog = None
    try:
        events.note_progress()  # the wedged build's last activity
        watchdog = flightrecorder.StallWatchdog(
            WINDOW, recorder, str(bundle_path),
            cell=events.progress_cell()).start()
        deadline = time.monotonic() + DEADLINE
        while (not bundle_path.exists()
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        if watchdog is not None:
            watchdog.stop()
        stop_sibling.set()
        noisy.join(timeout=5)
        events.reset_progress_cell(cell_token)
    assert bundle_path.exists(), \
        "sibling progress masked the per-build watchdog"
    assert json.loads(bundle_path.read_text())["reason"] == "stall"


def test_watchdog_respects_active_fn(tmp_path):
    """An idle worker (active_fn False) must never read as stalled,
    no matter how long nothing happens."""
    bundle_path = tmp_path / "idle-bundle.json"
    recorder = flightrecorder.FlightRecorder()
    watchdog = flightrecorder.StallWatchdog(
        WINDOW, recorder, str(bundle_path), active_fn=lambda: False).start()
    try:
        time.sleep(3 * WINDOW)
    finally:
        watchdog.stop()
    assert not bundle_path.exists()


def test_sigusr1_dump_does_not_suppress_failure_dump(tmp_path):
    """A SIGUSR1 inspection poke is not a terminal capture: the build's
    eventual failure bundle must still be written. Only stall/SIGTERM
    dumps — which froze the interesting moment — suppress it."""
    recorder = flightrecorder.FlightRecorder()
    recorder.dump(str(tmp_path / "poke.json"), "SIGUSR1")
    assert recorder.dumped
    assert not recorder.captured_terminal_moment()
    recorder.dump(str(tmp_path / "stall.json"), "stall")
    assert recorder.captured_terminal_moment()


def test_signal_dumps_only_on_the_main_thread(tmp_path):
    """Signal handlers are process state: a command run off the main
    thread (a build driven from a helper thread) installs none and
    restores none, and the process's own handlers stay in place."""
    recorder = flightrecorder.FlightRecorder()
    before = signal.getsignal(signal.SIGUSR1)
    got = []
    t = threading.Thread(target=lambda: got.append(
        flightrecorder.install_signal_dumps(
            recorder, metrics.global_registry(), str(tmp_path / "b.json"))))
    t.start()
    t.join(timeout=DEADLINE)
    assert got == [{}]
    assert signal.getsignal(signal.SIGUSR1) is before
    old = flightrecorder.install_signal_dumps(
        recorder, metrics.global_registry(), str(tmp_path / "b.json"))
    try:
        assert signal.SIGUSR1 in old
        assert signal.getsignal(signal.SIGUSR1) is not before
    finally:
        flightrecorder.restore_signal_handlers(old)
    assert signal.getsignal(signal.SIGUSR1) is before


def test_failure_dump_via_diag_out(tmp_path, capsys):
    """A plain failing build with --diag-out leaves a bundle with
    reason=failure and the exit code."""
    bundle_path = tmp_path / "fail-bundle.json"
    code = cli.main(["--diag-out", str(bundle_path),
                     "build", str(tmp_path / "nonexistent-ctx"),
                     "-t", "x:y",
                     "--storage", str(tmp_path / "storage"),
                     "--root", str(tmp_path / "root")], device="cpu")
    assert code == 1
    bundle = json.loads(bundle_path.read_text())
    assert bundle["reason"] == "failure"
    assert bundle["exit_code"] == 1
    assert bundle["schema"] == "makisu-tpu.flightrecorder.v1"
    # The ring captured the build lifecycle events.
    types = [e["type"] for e in bundle["events"]]
    assert "build_start" in types and "build_end" in types


def test_no_dump_without_opt_in(tmp_path, monkeypatch):
    """Without --diag-out or $MAKISU_TPU_DIAG_DIR a failing build
    writes no bundle (tests and ad-hoc runs must not litter /tmp)."""
    monkeypatch.delenv("MAKISU_TPU_DIAG_DIR", raising=False)
    before = set(os.listdir(tmp_path))
    code = cli.main(["build", str(tmp_path / "nope"), "-t", "x:y",
                     "--storage", str(tmp_path / "s"),
                     "--root", str(tmp_path / "r")], device="cpu")
    assert code == 1
    assert set(os.listdir(tmp_path)) == before


def test_failure_dump_via_diag_dir_env(tmp_path, monkeypatch):
    diag_dir = tmp_path / "diag"
    monkeypatch.setenv("MAKISU_TPU_DIAG_DIR", str(diag_dir))
    code = cli.main(["build", str(tmp_path / "nope"), "-t", "x:y",
                     "--storage", str(tmp_path / "s"),
                     "--root", str(tmp_path / "r")], device="cpu")
    assert code == 1
    bundles = list(diag_dir.glob("makisu-tpu-diag-*-failure.json"))
    assert len(bundles) == 1
    assert json.loads(bundles[0].read_text())["reason"] == "failure"


def _serve_wedge_image(reg):
    """Publish a one-layer image on a miniregistry whose every request
    sleeps: a FROM pull against it wedges a real build."""
    import gzip
    import io
    import tarfile

    from makisu_tpu_torch.docker.image import (
        MEDIA_TYPE_CONFIG,
        MEDIA_TYPE_LAYER,
        Descriptor,
        Digest,
        DistributionManifest,
        ImageConfig,
    )

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w|") as tw:
        info = tarfile.TarInfo("base.txt")
        payload = b"wedge" * 64
        info.size = len(payload)
        tw.addfile(info, io.BytesIO(payload))
    layer = gzip.compress(buf.getvalue(), mtime=0)
    config = ImageConfig()
    config.rootfs.diff_ids = [
        str(Digest.of_bytes(gzip.decompress(layer)))]
    config_blob = config.to_bytes()
    manifest = DistributionManifest(
        config=Descriptor(MEDIA_TYPE_CONFIG, len(config_blob),
                          Digest.of_bytes(config_blob)),
        layers=[Descriptor(MEDIA_TYPE_LAYER, len(layer),
                           Digest.of_bytes(layer))])
    repo = reg.state.repo("wedge/base")
    repo.blobs[str(Digest.of_bytes(config_blob))] = config_blob
    repo.blobs[str(Digest.of_bytes(layer))] = layer
    raw = manifest.to_bytes()
    media = "application/vnd.docker.distribution.manifest.v2+json"
    repo.manifests["1"] = (media, raw)
    repo.manifests[str(Digest.of_bytes(raw))] = (media, raw)
    repo.tags.add("1")


def test_sigterm_leaves_bundle(tmp_path):
    """Acceptance: a real build (subprocess) wedged pulling FROM a
    stalled registry and killed by SIGTERM leaves a bundle on disk
    that names the open span chain and the thread stacks."""
    from makisu_tpu_torch.tools.miniregistry import MiniRegistry

    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (tmp_path / "root").mkdir()
    bundle_path = tmp_path / "sigterm-bundle.json"
    with MiniRegistry(latency_s=30.0) as reg:
        _serve_wedge_image(reg)
        (ctx / "Dockerfile").write_text(
            f"FROM {reg.addr}/wedge/base:1\n")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("MAKISU_TPU_DIAG_DIR", None)
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys\n"
             "from makisu_tpu_torch import cli\n"
             "sys.exit(cli.main(sys.argv[1:], device='cpu'))",
             "--diag-out", str(bundle_path),
             "build", str(ctx), "-t", "wedge/app:1",
             "--storage", str(tmp_path / "storage"),
             "--root", str(tmp_path / "root")],
            env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        try:
            # Wait until the build is provably wedged inside the
            # registry's latency sleep (its first request arrived).
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if reg.state.requests:
                    break
                if proc.poll() is not None:
                    pytest.fail("build exited before wedging")
                time.sleep(0.1)
            assert reg.state.requests, "build never reached the registry"
            time.sleep(0.3)  # let it sink into the blocking read
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=60)
        finally:
            proc.kill()
    assert code == 128 + signal.SIGTERM
    bundle = json.loads(bundle_path.read_text())
    assert bundle["reason"] == "SIGTERM"
    # The open span chain reaches into the build; stacks captured.
    assert bundle["open_spans"], "no open spans in SIGTERM bundle"
    assert {"build"} <= {s["name"] for s in bundle["open_spans"]}
    assert any(t["name"] == "MainThread" for t in bundle["threads"])
    text = flightrecorder.render_doctor(bundle)
    assert "SIGTERM" in text


def test_watch_process_sigterm_leaves_bundle(tmp_path):
    """The port's long-lived process is `build --watch`: SIGTERM while
    it watches dumps one bundle (reason SIGTERM) whose ring holds the
    first build's events, and the process exits 143."""
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY f /f\n")
    (ctx / "f").write_text("x")
    (tmp_path / "root").mkdir()
    bundle_path = tmp_path / "watch-bundle.json"
    log_path = tmp_path / "watch.log"
    env = dict(os.environ)
    env.pop("MAKISU_TPU_DIAG_DIR", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "makisu_tpu_torch.cli",
         "--log-output", str(log_path), "--diag-out", str(bundle_path),
         "build", str(ctx), "-t", "wt/app:1", "--hasher", "cpu",
         "--storage", str(tmp_path / "storage"),
         "--root", str(tmp_path / "root"), "--watch"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if log_path.exists() and "initial build exited 0" in \
                    log_path.read_text():
                break
            if proc.poll() is not None:
                pytest.fail("watch process exited early")
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    finally:
        proc.kill()
    assert code == 128 + signal.SIGTERM
    bundle = json.loads(bundle_path.read_text())
    assert bundle["reason"] == "SIGTERM"
    types = [e["type"] for e in bundle["events"]]
    assert "build_start" in types and "step" in types


def test_sigusr1_dumps_and_continues(tmp_path):
    """SIGUSR1 is the live-inspection signal: bundle written
    mid-build, build keeps running to a normal exit. The kick fires
    from an event sink on the first `step` event, so the signal
    provably lands while the build is inside its span tree."""
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY d.txt /d.txt\n")
    (ctx / "d.txt").write_text("payload")
    (tmp_path / "root").mkdir()
    bundle_path = tmp_path / "usr1-bundle.json"
    fired = []

    def kicker(event):
        if event["type"] == "step" and not fired:
            fired.append(event)
            os.kill(os.getpid(), signal.SIGUSR1)

    events.add_global_sink(kicker)
    try:
        code = cli.main([
            "--diag-out", str(bundle_path),
            "build", str(ctx), "-t", "usr1/app:1",
            "--storage", str(tmp_path / "storage"),
            "--root", str(tmp_path / "root"),
            "--dest", str(tmp_path / "out.tar")], device="cpu")
    finally:
        events.remove_global_sink(kicker)
    assert fired, "no step event — the kick never happened"
    assert code == 0
    assert (tmp_path / "out.tar").exists()  # the build FINISHED
    bundle = json.loads(bundle_path.read_text())
    assert bundle["reason"] == "SIGUSR1"
    # Captured mid-build: the build/stage spans were open.
    assert {"build"} <= {s["name"] for s in bundle["open_spans"]}


# -- sampling profiler --------------------------------------------------

# A scripted call chain whose frames live in THIS file — the folded
# stack must spell it out root-first. The spin is pure arithmetic (no
# Event waits) so no parking frames sit between the golden frames.
def _golden_inner(stop: list) -> int:
    x = 0
    while not stop[0]:
        x = (x + 1) & 0xFFFF
    return x


def _golden_mid(stop: list) -> int:
    return _golden_inner(stop)


def _golden_outer(stop: list) -> int:
    return _golden_mid(stop)


_GOLDEN = ("_golden_outer (test_torch_forensics.py);"
           "_golden_mid (test_torch_forensics.py);"
           "_golden_inner (test_torch_forensics.py)")


def _spin(seconds: float) -> float:
    end = time.monotonic() + seconds
    x = 0
    while time.monotonic() < end:
        x = (x + 1) & 0xFFFF
    return time.monotonic() - (end - seconds)


def test_folded_stack_golden_busy_loop():
    """A busy thread with a known call chain yields a folded stack
    containing outer;mid;inner in root-first order, and that stack
    owns the thread's samples (the golden-shape contract renderers
    and diffs depend on)."""
    stop = [False]
    worker = threading.Thread(target=_golden_outer, args=(stop,),
                              name="golden-busy")
    prof = profiler.SamplingProfiler(hz=250.0)
    worker.start()
    prof.start()
    try:
        deadline = time.monotonic() + DEADLINE
        doc = prof.snapshot(command="test")
        while time.monotonic() < deadline:
            doc = prof.snapshot(command="test")
            if any(_GOLDEN in row["stack"] for row in doc["stacks"]):
                break
            time.sleep(0.02)
    finally:
        stop[0] = True
        worker.join(timeout=5.0)
        prof.stop()
    golden = [row for row in doc["stacks"] if _GOLDEN in row["stack"]]
    assert golden, [row["stack"] for row in doc["stacks"]][:10]
    # The leaf frame is the spin itself — never a parking frame.
    for row in golden:
        assert row["stack"].endswith("_golden_inner (test_torch_forensics.py)")
    assert doc["schema"] == profiler.PROFILE_SCHEMA
    assert doc["samples"] >= sum(row["count"] for row in golden) > 0


def test_phase_attribution_matches_span_self_times():
    """A scripted build — a hash-phase span spinning ~2x as long as a
    push-phase span — must show up in the sampler's phase tallies at
    the same ratio, within tolerance (the acceptance gate's
    profile-vs-report agreement, scaled down)."""
    reg = metrics.MetricsRegistry()
    reg_token = metrics.set_build_registry(reg)
    bind_token = profiler.bind_thread(reg.trace_id)
    prof = profiler.SamplingProfiler(hz=200.0)
    prof.start()
    try:
        # Warm the sampler past its expensive first pass (cold-path
        # setup makes the governor stretch the first sleep ~100x);
        # these samples land in "other", outside the measured phases.
        _spin(0.1)
        time.sleep(0.5)
        with metrics.span("build"):
            with metrics.span("hash_lanes"):
                t_hash = _spin(0.6)
            with metrics.span("push_layer"):
                t_push = _spin(0.3)
    finally:
        prof.stop()
        profiler.unbind_thread(bind_token)
        metrics.reset_build_registry(reg_token)
    doc = prof.snapshot(command="test")
    hash_n = doc["phases"].get("hash", 0)
    push_n = doc["phases"].get("push", 0)
    assert hash_n > 0 and push_n > 0, doc["phases"]
    sampled_share = hash_n / (hash_n + push_n)
    span_share = t_hash / (t_hash + t_push)
    assert abs(sampled_share - span_share) <= 0.15, (
        f"sampled hash share {sampled_share:.2f} vs span self-time "
        f"share {span_share:.2f}")
    # The samples carry the build's trace id, not the anonymous bucket.
    assert doc["traces"].get(reg.trace_id, 0) > 0


def test_overhead_under_hundred_parked_threads():
    """100 parked pool threads (pure threading.py waits) must neither
    contribute samples nor blow the self-measured overhead budget:
    the governor keeps cumulative overhead under 5% even while the
    sampler walks 100+ frames per pass."""
    release = threading.Event()
    parked = [threading.Thread(target=release.wait, args=(30.0,),
                               name=f"parked-{i}", daemon=True)
              for i in range(100)]
    for t in parked:
        t.start()
    stop = [False]
    busy = threading.Thread(target=_golden_outer, args=(stop,),
                            name="busy-under-pressure")
    busy.start()
    prof = profiler.SamplingProfiler().start()
    try:
        time.sleep(1.2)
    finally:
        stop[0] = True
        release.set()
        busy.join(timeout=5.0)
        prof.stop()
    stats = prof.stats()
    assert stats["samples_total"] > 0
    assert stats["overhead_fraction"] < 0.05, stats
    doc = prof.snapshot(command="test")
    # Parked threads are invisible: every recorded stack ends in a
    # real frame, none in threading.py's wait plumbing.
    for row in doc["stacks"]:
        leaf = row["stack"].rsplit(";", 1)[-1]
        assert "(threading.py)" not in leaf, row["stack"]


def _doc(stacks: list[tuple[str, str, int]]) -> dict:
    total = sum(count for _, _, count in stacks)
    phases: dict = {}
    for _, phase, count in stacks:
        phases[phase] = phases.get(phase, 0) + count
    return {
        "schema": profiler.PROFILE_SCHEMA, "ts": 0.0, "pid": 1,
        "command": "test", "hz": 67.0, "duration_seconds": 1.0,
        "samples": total, "passes": total, "dropped": 0,
        "throttled": 0, "overhead_fraction": 0.001,
        "budget_fraction": 0.02, "phases": phases, "traces": {},
        "stacks": [{"stack": stack, "phase": phase, "count": count}
                   for stack, phase, count in stacks],
    }


def test_profile_diff_flags_injected_hot_frame(tmp_path, capsys):
    """An injected frame whose self-time share doubled past the
    threshold is named as the top regression and the CLI exits 1;
    A-vs-A flags nothing (exit 0); unreadable input exits 2."""
    baseline = _doc([
        ("build (cli.py);pull_layer (registry.py)", "pull", 70),
        ("build (cli.py);commit (builder.py);sha256 (hash.py)",
         "hash", 30),
    ])
    candidate = _doc([
        ("build (cli.py);pull_layer (registry.py)", "pull", 35),
        ("build (cli.py);commit (builder.py);sha256 (hash.py)",
         "hash", 65),
    ])
    a = str(tmp_path / "a.json")
    b = str(tmp_path / "b.json")
    profiler.write_artifact(a, baseline)
    profiler.write_artifact(b, candidate)

    result = profiler.diff(baseline, candidate, threshold=0.1)
    assert not result["ok"]
    assert result["regressions"][0]["frame"] == "sha256 (hash.py)"

    assert cli.main(["profile", "diff", a, b]) == 1
    out = capsys.readouterr().out
    assert "REGRESSION" in out and "sha256 (hash.py)" in out

    assert cli.main(["profile", "diff", a, a]) == 0
    assert "ok" in capsys.readouterr().out

    junk = str(tmp_path / "junk.json")
    with open(junk, "w", encoding="utf-8") as f:
        f.write("{not json")
    with pytest.raises(SystemExit) as excinfo:
        cli.main(["profile", "diff", a, junk])
    assert excinfo.value.code == 2


def test_bounded_memory_cap_under_stack_churn():
    """Past max_stacks distinct folded shapes, new shapes increment
    `dropped` instead of growing the dict — the bounded-memory
    contract for a long-lived worker under stack-shape churn. Trace
    ids collapse into the anonymous bucket past their own cap."""
    prof = profiler.SamplingProfiler(hz=0.0, max_stacks=16)
    for i in range(300):
        prof._count(f"f{i} (churn.py)", "other", f"trace-{i}")
    assert len(prof._stacks) == 16
    assert prof.dropped == 300 - 16
    # Every sample still counts toward totals — the cap drops SHAPES,
    # not the record that sampling happened.
    assert prof.samples_total == 300
    assert prof._phases["other"] == 300
    # 256 distinct traces + the "" overflow bucket, never more.
    assert len(prof._traces) <= profiler._MAX_TRACES + 1
    assert prof._traces.get("", 0) > 0


def test_window_and_merge_algebra():
    """window()/subtract() answer "what is it doing NOW" (counts are
    deltas), and merge_profiles sums per-worker documents while
    keeping per-worker vitals."""
    before = _doc([("a (x.py)", "hash", 10), ("b (y.py)", "pull", 5)])
    after = _doc([("a (x.py)", "hash", 25), ("b (y.py)", "pull", 5),
                  ("c (z.py)", "push", 3)])
    delta = profiler.subtract(after, before)
    got = {row["stack"]: row["count"] for row in delta["stacks"]}
    assert got == {"a (x.py)": 15, "c (z.py)": 3}
    assert delta["samples"] == after["samples"] - before["samples"]

    merged = profiler.merge_profiles({"w0": before, "w1": after})
    assert merged["command"] == "fleet"
    assert merged["samples"] == before["samples"] + after["samples"]
    assert set(merged["workers"]) == {"w0", "w1"}
    rows = {row["stack"]: row["count"] for row in merged["stacks"]}
    assert rows["a (x.py)"] == 35


def test_resolve_hz_chain(monkeypatch):
    """Flag > env > default; zero or garbage disables."""
    monkeypatch.delenv("MAKISU_TPU_PROFILE_HZ", raising=False)
    assert profiler.resolve_hz() == profiler.DEFAULT_HZ
    assert profiler.resolve_hz(19.0) == 19.0
    assert profiler.resolve_hz(0.0) == 0.0
    monkeypatch.setenv("MAKISU_TPU_PROFILE_HZ", "31")
    assert profiler.resolve_hz() == 31.0
    assert profiler.resolve_hz(19.0) == 19.0
    monkeypatch.setenv("MAKISU_TPU_PROFILE_HZ", "garbage")
    assert profiler.resolve_hz() == 0.0
    monkeypatch.setenv("MAKISU_TPU_PROFILE_HZ", "0")
    assert profiler.resolve_hz() == 0.0


def test_artifact_round_trip_and_speedscope(tmp_path):
    """write_artifact embeds a speedscope profile whose weights carry
    the counts; read_artifact validates the schema."""
    doc = _doc([("a (x.py);b (y.py)", "hash", 7)])
    path = str(tmp_path / "p.json")
    profiler.write_artifact(path, doc)
    loaded = profiler.read_artifact(path)
    assert loaded["schema"] == profiler.PROFILE_SCHEMA
    scope = loaded["speedscope"]
    assert scope["profiles"][0]["weights"] == [7]
    names = [f["name"] for f in scope["shared"]["frames"]]
    assert names == ["a (x.py)", "b (y.py)"]
    with pytest.raises(ValueError):
        profiler.read_artifact(str(tmp_path / "missing.json"))
    wrong = str(tmp_path / "wrong.json")
    with open(wrong, "w", encoding="utf-8") as f:
        json.dump({"schema": "other.v1"}, f)
    with pytest.raises(ValueError):
        profiler.read_artifact(wrong)


# -- resource sampler ---------------------------------------------------

def test_read_sample_shape():
    sample = resources.read_sample()
    assert sample["rss_bytes"] > 0
    assert sample["cpu_seconds"] > 0
    assert sample["threads"] >= 1
    # Linux CI/dev hosts have procfs; these fields must be present
    # there (they degrade away only on exotic hosts).
    assert sample.get("open_fds", 1) >= 1


def test_sampler_publishes_gauges_and_trajectory():
    sampler = resources.ResourceSampler(interval=60)  # manual ticks
    sampler.sample_once()
    sampler.sample_once()
    assert len(sampler.trajectory()) == 2
    g = metrics.global_registry()
    assert g.gauge_value("makisu_process_rss_bytes") > 0
    assert g.gauge_value("makisu_process_cpu_seconds") > 0
    assert g.gauge_value("makisu_process_threads") >= 1


def test_samples_attribute_to_open_spans():
    """Open spans record peak RSS; CPU burned between samples charges
    the open leaf. Closed spans carry the result in to_dict()."""
    resources.stop()  # the process singleton must not race the asserts
    sampler = resources.ResourceSampler(interval=60)
    registry = metrics.MetricsRegistry()
    token = metrics.set_build_registry(registry)
    try:
        with metrics.span("push_layers") as outer:
            with metrics.span("hash_batch") as inner:
                sampler.sample_once()
                # Burn measurable CPU between the two samples.
                t0 = time.process_time()
                while time.process_time() - t0 < 0.05:
                    sum(i * i for i in range(10_000))
                sampler.sample_once()
    finally:
        metrics.reset_build_registry(token)
    for span in (outer, inner):
        d = span.to_dict()
        assert d["resources"]["peak_rss_bytes"] > 0
    # The leaf (inner) got the CPU charge, not the parent.
    assert inner.to_dict()["resources"]["cpu_seconds"] > 0
    assert outer.to_dict()["resources"]["cpu_seconds"] == 0


def test_span_without_sampling_has_no_resources():
    with metrics.span("quick") as s:
        pass
    assert "resources" not in s.to_dict()


def test_report_renders_resources_by_phase():
    report = {
        "schema": "makisu-tpu.metrics.v1",
        "spans": [{
            "name": "build", "span_id": "aa", "start": 100.0,
            "duration": 2.0,
            "resources": {"peak_rss_bytes": 64 << 20,
                          "cpu_seconds": 0.5},
            "children": [{
                "name": "push_layers", "span_id": "bb",
                "start": 100.5, "duration": 1.0,
                "resources": {"peak_rss_bytes": 128 << 20,
                              "cpu_seconds": 0.25},
            }],
        }],
    }
    by_phase = traceexport.resources_by_phase(report)
    assert by_phase["push"]["peak_rss_bytes"] == 128 << 20
    assert by_phase["other"]["cpu_seconds"] == 0.5
    text = traceexport.render_report(report)
    assert "resource usage by phase" in text
    assert "128.0MiB" in text


def test_ensure_started_is_idempotent():
    first = resources.ensure_started(interval=30)
    second = resources.ensure_started(interval=1)
    assert first is second
    resources.stop()


# -- build history ------------------------------------------------------

def _synthetic(duration: float, i: int = 0, hits: int = 8,
               misses: int = 2, reused: int = 90,
               added: int = 10) -> dict:
    return {
        "schema": history.HISTORY_SCHEMA,
        "ts": 1_700_000_000.0 + i,
        "trace_id": f"{i:032x}",
        "command": "build",
        "exit_code": 0,
        "duration_seconds": duration,
        "phase_self_seconds": {"hash": duration * 0.6},
        "cache": {"hits": hits, "misses": misses,
                  "hit_ratio": hits / (hits + misses),
                  "chunk_bytes_added": added,
                  "chunk_bytes_reused": reused,
                  "chunk_dedup_ratio": reused / (added + reused)},
        "bytes_hashed": {"native": 1000},
        "backend": "cpu", "native_isa": "", "mode": "standalone",
        "hasher": "gpu",
    }


def _write(path, records):
    for r in records:
        history.append_record(str(path), r)


def _build(tmp_path, name, extra_argv=()):
    ctx = tmp_path / f"{name}-ctx"
    if not ctx.exists():
        ctx.mkdir()
        (ctx / "Dockerfile").write_text(
            "FROM scratch\nCOPY data /data\n")
        (ctx / "data").write_text("history payload\n" * 2048)
        (tmp_path / f"{name}-root").mkdir()
    return cli.main(list(extra_argv) + [
        "--log-level", "error", "build", str(ctx),
        "-t", f"hist/{name}:1", "--hasher", "gpu",
        "--storage", str(tmp_path / f"{name}-storage"),
        "--root", str(tmp_path / f"{name}-root")], device="cpu")


# -- round trip through a real build ---------------------------------------


def test_build_appends_history_record(tmp_path):
    out = tmp_path / "hist.jsonl"
    assert _build(tmp_path, "rt",
                  ["--history-out", str(out)]) == 0
    assert _build(tmp_path, "rt",
                  ["--history-out", str(out)]) == 0  # warm append
    records = history.read_history(str(out))
    assert len(records) == 2
    cold, warm = records
    for r in records:
        assert r["schema"] == history.HISTORY_SCHEMA
        assert r["command"] == "build"
        assert r["exit_code"] == 0
        assert r["duration_seconds"] > 0
        assert len(r["trace_id"]) == 32
        assert r["mode"] == "standalone"
        assert r["hasher"] == "gpu"
        assert r["phase_self_seconds"]  # traceexport split present
    # The warm rebuild hit the cache; the cold one could not (and a
    # full-hit rebuild hashes zero bytes — that IS the cache working).
    assert sum(cold["bytes_hashed"].values()) > 0
    assert cold["cache"]["hits"] == 0
    assert warm["cache"]["hits"] > 0
    assert warm["cache"]["hit_ratio"] > 0
    # Distinct builds, ordered by time.
    assert cold["trace_id"] != warm["trace_id"]
    assert cold["ts"] <= warm["ts"]


def test_history_dir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_HISTORY_DIR",
                       str(tmp_path / "histdir"))
    assert _build(tmp_path, "env") == 0
    out = tmp_path / "histdir" / history.HISTORY_BASENAME
    assert out.exists()
    assert len(history.read_history(str(tmp_path / "histdir"))) == 1
    # The explicit flag wins over the env dir.
    flagged = tmp_path / "flagged.jsonl"
    assert _build(tmp_path, "env",
                  ["--history-out", str(flagged)]) == 0
    assert len(history.read_history(str(flagged))) == 1
    assert len(history.read_history(str(out))) == 1


def test_resolve_out(monkeypatch):
    monkeypatch.delenv("MAKISU_TPU_HISTORY_DIR", raising=False)
    assert history.resolve_out("") == ""
    assert history.resolve_out("/x/f.jsonl") == "/x/f.jsonl"
    monkeypatch.setenv("MAKISU_TPU_HISTORY_DIR", "/var/hist")
    assert history.resolve_out("") == \
        "/var/hist/" + history.HISTORY_BASENAME
    assert history.resolve_out("/x/f.jsonl") == "/x/f.jsonl"


def test_concurrent_appends_stay_whole(tmp_path):
    """N threads appending to ONE history file (the loadgen shape)
    leave N parseable records — O_APPEND single-write discipline."""
    out = tmp_path / "c.jsonl"
    threads = [
        threading.Thread(target=_write, args=(
            out, [_synthetic(1.0, i * 10 + j) for j in range(10)]))
        for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(history.read_history(str(out))) == 50


def test_read_history_skips_foreign_lines(tmp_path):
    out = tmp_path / "m.jsonl"
    out.write_text(json.dumps(_synthetic(1.0)) + "\n"
                   + '{"schema": "other.v1"}\n'
                   + "not json at all\n"
                   + json.dumps(_synthetic(2.0, 1)) + "\n")
    records = history.read_history(str(out))
    assert [r["duration_seconds"] for r in records] == [1.0, 2.0]


# -- aggregation + the regression gate -------------------------------------


def test_aggregate():
    records = [_synthetic(1.0 + i * 0.1, i) for i in range(10)]
    records[3]["exit_code"] = 1
    agg = history.aggregate(records)
    assert agg["records"] == 10
    assert agg["failures"] == 1
    assert agg["duration_p50"] == pytest.approx(1.4)
    assert agg["duration_p99"] == pytest.approx(1.9)
    assert agg["cache_hit_ratio"] == pytest.approx(0.8)
    assert agg["chunk_dedup_ratio"] == pytest.approx(0.9)


def test_diff_flags_2x_latency_regression(tmp_path):
    """The acceptance gate: an injected 2x latency regression between
    two history files is flagged, and the CLI exits 1 on it."""
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _write(a, [_synthetic(1.0 + i * 0.01, i) for i in range(10)])
    _write(b, [_synthetic(2.0 + i * 0.01, i) for i in range(10)])
    result = history.diff(history.read_history(str(a)),
                          history.read_history(str(b)))
    assert not result["ok"]
    flagged = {r["metric"] for r in result["regressions"]}
    assert "duration_p50" in flagged and "duration_p99" in flagged
    text = history.render_diff(result)
    assert "← REGRESSION" in text
    assert "REGRESSION: duration_p50" in text
    # CLI gate: exit 1 on regression, 0 on parity; rendered output.
    assert cli.main(["history", "diff", str(a), str(b)]) == 1
    assert cli.main(["history", "diff", str(a), str(a)]) == 0
    # Reversed (candidate got FASTER): not a regression.
    assert cli.main(["history", "diff", str(b), str(a)]) == 0


def test_diff_flags_cache_ratio_drop(tmp_path):
    a = [_synthetic(1.0, i) for i in range(5)]
    b = [_synthetic(1.0, i, hits=2, misses=8, reused=10, added=90)
         for i in range(5)]
    result = history.diff(a, b)
    flagged = {r["metric"] for r in result["regressions"]}
    assert flagged == {"cache_hit_ratio", "chunk_dedup_ratio"}


def test_diff_threshold_respected():
    a = [_synthetic(1.0, i) for i in range(5)]
    b = [_synthetic(1.2, i) for i in range(5)]  # +20%
    assert history.diff(a, b, threshold=0.25)["ok"]
    assert not history.diff(a, b, threshold=0.15)["ok"]


def test_diff_empty_sides_do_not_flag():
    assert history.diff([], [_synthetic(5.0)])["ok"]
    assert history.diff([_synthetic(5.0)], [])["ok"]


def test_history_trend_render(tmp_path):
    out = tmp_path / "t.jsonl"
    _write(out, [_synthetic(1.0 + i * 0.5, i) for i in range(4)])
    text = history.render_trends(history.read_history(str(out)))
    assert "4 records" in text
    assert "duration p50" in text and "p99" in text
    assert "cache hit ratio 80.0%" in text
    assert text.count("build") >= 4
    # CLI render path.
    assert cli.main(["history", str(out)]) == 0


def test_history_diff_bad_usage():
    with pytest.raises(SystemExit):
        cli.main(["history", "diff", "only-one"])


def test_percentile_helpers():
    from makisu_tpu_torch.utils import metrics
    vals = list(range(1, 101))
    assert metrics.percentile(vals, 50) == 50
    assert metrics.percentile(vals, 99) == 99
    assert metrics.percentile([7.0], 99) == 7.0
    stats = metrics.percentile_stats([3.0, 1.0, 2.0])
    assert stats == {"count": 3, "p50": 2.0, "p90": 3.0, "p99": 3.0,
                     "max": 3.0}
    assert metrics.percentile_stats([]) == {"count": 0}
    with pytest.raises(ValueError):
        metrics.percentile([], 50)


def test_history_missing_path_exits_2(tmp_path):
    """A missing/unreadable history file exits 2 with a clean error —
    never a traceback, and never exit 1 (which means 'regression
    flagged' to a gate script)."""
    good = tmp_path / "good.jsonl"
    _write(good, [_synthetic(1.0)])
    for argv in (["history", str(tmp_path / "absent.jsonl")],
                 ["history", "diff", str(tmp_path / "absent.jsonl"),
                  str(good)],
                 ["history", "diff", str(good),
                  str(tmp_path / "absent.jsonl")]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2


# -- storage-plane snapshot ------------------------------------------------


def test_aggregate_carries_latest_storage_snapshot():
    a = _synthetic(1.0)
    a["storage_bytes"] = {"chunks": 100, "blobs": 10, "total": 110}
    b = _synthetic(1.0)
    b["storage_bytes"] = {"chunks": 300, "blobs": 10, "total": 310}
    b["ts"] = a["ts"] + 1
    agg = history.aggregate([a, b])
    assert agg["storage_bytes"]["chunks"] == 300  # latest wins


def test_diff_flags_storage_plane_growth():
    a = _synthetic(1.0)
    a["storage_bytes"] = {"chunks": 1000, "blobs": 500, "total": 1500}
    b = _synthetic(1.0)
    b["storage_bytes"] = {"chunks": 2000, "blobs": 500, "total": 2500}
    result = history.diff([a], [b], threshold=0.25)
    assert not result["ok"]
    assert result["storage_growth"] == [{
        "plane": "chunks", "baseline": 1000, "candidate": 2000,
        "change": 1.0}]
    rendered = history.render_diff(result)
    assert "GROWTH" in rendered and "storage:chunks" in rendered
    # Growth within threshold (and records without snapshots) pass.
    assert history.diff([a], [a], threshold=0.25)["ok"]
    assert history.diff([_synthetic(1.0)], [b],
                        threshold=0.25)["ok"]


def test_build_record_labels_come_from_the_port(tmp_path):
    """The record's device-route and warm-mode labels are the port's
    own state, even with the reference's modules loaded in the same
    process; without a storage census the record has no storage_bytes
    (the census is not part of the port)."""
    out = tmp_path / "hist.jsonl"
    assert _build(tmp_path, "sb", ("--history-out", str(out))) == 0
    record = history.read_history(str(out))[-1]
    assert "storage_bytes" not in record
    # device="cpu" resolves no CUDA device: the port's plane is absent.
    assert record["device_probe"] == "absent"
    assert record["warm_mode"] in ("fresh", "off")
