"""A build through the port writes the reference's telemetry artifacts.

One seeded context is built cold, then warm, by
``makisu_tpu.cli.main([... "--hasher", "tpu"])`` on JAX's CPU and by
``makisu_tpu_torch.cli.main([... "--hasher", "gpu"], device="cpu")``,
each into its own storage and with every telemetry output. The two
packages must agree on the counter names and label keys, the
deterministic counter values (the ``backend`` label's value aside), the
chunk-size histogram, the span names, the event sequence, the ledger
lines and the history records. The route differences are stated where
they are excluded: on the CPU the reference chunks on its native C++
chunker, which has no device plane, while the port runs its device ring
on the kernels' plain versions, so only the port exports the
``makisu_device_*`` series; only the port writes the counters of
``metrics.PORT_COUNTERS``; and only the port opens the spans of
``metrics.PORT_SPANS`` (with their ``span_start``/``span_end`` events)
and logs ``span_seconds``, ``device_busy_seconds``, ``commit_entries``
and ``chunk_probes`` on its "build telemetry" line: exactly those are
taken out before the comparison.
Each package's readers then render the other's artifacts, with the
same text."""

import collections
import json
import os
import time

import numpy as np
import pytest

from makisu_tpu import cli as ref_cli
from makisu_tpu.utils import metrics as ref_metrics
from makisu_tpu.utils import mountinfo as ref_mountinfo
from makisu_tpu.worker import session as ref_session
from makisu_tpu_torch import cli
from makisu_tpu_torch.utils import metrics, mountinfo, traceexport
from makisu_tpu_torch.worker import session

PKGS = ("ref", "port")
DOCKERFILE = """\
FROM scratch
COPY app /app/
ENV APP_ENV=prod
COPY app/f0.bin /x.bin
"""
# Series whose values are times, not counts.
_TIMED = ("makisu_commit_stage_busy_seconds",)
_DEVICE = "makisu_device_"


def make_context(path, seed=3):
    rng = np.random.default_rng(seed)
    (path / "app").mkdir(parents=True)
    for k in range(6):
        size = int(rng.integers(1000, 60000))
        (path / "app" / f"f{k}.bin").write_bytes(
            rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    (path / "Dockerfile").write_text(DOCKERFILE)


def outputs(base, tag):
    return ["--log-fmt", "json", "--log-output", str(base / f"log{tag}"),
            "--metrics-out", str(base / f"R{tag}.json"),
            "--events-out", str(base / f"E{tag}.jsonl"),
            "--explain-out", str(base / f"L{tag}.jsonl"),
            "--trace-out", str(base / f"T{tag}.json"),
            "--profile-out", str(base / f"P{tag}.json"),
            "--history-out", str(base / "H.jsonl"),
            "--stall-timeout", "600"]


def run_build(pkg, argv):
    """One build as a process of its own: a fresh session manager, whose
    sessions close with the build (their inotify instances released)."""
    mod = session if pkg == "port" else ref_session
    mgr = mod.SessionManager()
    token = mod.bind_manager(mgr)
    try:
        if pkg == "port":
            return cli.main(argv + ["--hasher", "gpu"], device="cpu")
        return ref_cli.main(argv + ["--hasher", "tpu"])
    finally:
        mod.reset_manager(token)
        mgr.reset()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Cold (a) and warm (b) builds of one context by both packages,
    plus a failing build of each with --diag-out (a bundle)."""
    base = tmp_path_factory.mktemp("telemetry")
    ctx = base / "ctx"
    make_context(ctx)
    mountinfo.set_mountpoints_for_testing(set())
    ref_mountinfo.set_mountpoints_for_testing(set())
    old_window = os.environ.get("MAKISU_TPU_STAT_CACHE_WINDOW_NS")
    os.environ["MAKISU_TPU_STAT_CACHE_WINDOW_NS"] = "0"
    # A worker of an earlier test in this process may have turned the
    # shared hash service on for the process; these builds launch S1
    # themselves.
    shared = pytest.MonkeyPatch()
    shared.setenv("MAKISU_TPU_SHARED_HASH", "0")
    try:
        for pkg in PKGS:
            out = base / pkg
            for tag in "ab":
                (out / f"root{tag}").mkdir(parents=True)
                argv = outputs(out, tag) + [
                    "build", str(ctx), "-t", "tel/app:1",
                    "--storage", str(out / "storage"),
                    "--root", str(out / f"root{tag}")]
                assert run_build(pkg, argv) == 0, (pkg, tag)
            argv = ["--log-fmt", "json", "--log-output", str(out / "logf"),
                    "--diag-out", str(out / "bundle.json"),
                    "build", str(base / "missing"), "-t", "tel/app:1",
                    "--storage", str(out / "storage"),
                    "--root", str(out / "roota")]
            assert run_build(pkg, argv) == 1
    finally:
        if old_window is None:
            os.environ.pop("MAKISU_TPU_STAT_CACHE_WINDOW_NS")
        else:
            os.environ["MAKISU_TPU_STAT_CACHE_WINDOW_NS"] = old_window
        shared.undo()
        mountinfo.set_mountpoints_for_testing(None)
        ref_mountinfo.set_mountpoints_for_testing(None)
    return base


def report(built, pkg, tag):
    return json.loads((built / pkg / f"R{tag}.json").read_text())


def jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def counters(rep, route_series=False):
    """{(name, label keys): value summed over the backend label's
    values}, without the port's own counters, and without the device
    plane (and timed series) unless asked."""
    out = collections.Counter()
    for name, series in rep["counters"].items():
        if name in metrics.PORT_COUNTERS or not route_series and (
                name.startswith(_DEVICE) or name in _TIMED):
            continue
        for s in series:
            labels = {k: v for k, v in s["labels"].items()
                      if k != "backend"}
            out[(name, tuple(sorted(s["labels"])),
                 tuple(sorted(labels.items())))] += s["value"]
    return out


def without_port_spans(rep):
    """``rep`` with the spans of ``metrics.PORT_SPANS`` taken out of its
    tree (none has children: its time returns to its parent's self
    time), and a count of what was taken out, by name."""
    removed = collections.Counter()

    def strip(span):
        kept = []
        for child in span.get("children", []):
            if child["name"] in metrics.PORT_SPANS:
                assert not child.get("children")
                removed[child["name"]] += 1
            else:
                kept.append(strip(child))
        out = {k: v for k, v in span.items() if k != "children"}
        if kept:
            out["children"] = kept
        return out

    return dict(rep, spans=[strip(s) for s in rep["spans"]]), removed


def span_names(rep):
    names = collections.Counter()

    def walk(span):
        names[span["name"]] += 1
        for child in span.get("children", []):
            walk(child)

    for span in rep["spans"]:
        walk(span)
    return names


@pytest.mark.parametrize("tag", ["a", "b"])
def test_counter_names_and_label_keys_match(built, tag):
    names = {}
    for pkg in PKGS:
        rep = report(built, pkg, tag)
        names[pkg] = {(n, tuple(sorted(s["labels"])))
                      for n, series in rep["counters"].items()
                      for s in series if not n.startswith(_DEVICE)
                      and n not in metrics.PORT_COUNTERS}
    assert names["port"] == names["ref"]


@pytest.mark.parametrize("tag", ["a", "b"])
def test_deterministic_counters_match(built, tag):
    """Bytes hashed, gear-scan bytes, layer commits, bytes and chunks,
    stat-cache totals, cache pulls, cached layers applied, stages."""
    port = counters(report(built, "port", tag))
    ref = counters(report(built, "ref", tag))
    assert port == ref
    names = {k[0] for k in port}
    if tag == "a":
        assert {"makisu_bytes_hashed_total", "makisu_gear_scan_bytes_total",
                "makisu_layer_commits_total", "makisu_layer_bytes_total",
                "makisu_layer_chunks_total", "makisu_statcache_total",
                "makisu_cache_pull_total", "makisu_stages_total"} <= names
    else:
        assert "makisu_cached_layers_applied_total" in names


@pytest.mark.parametrize("tag", ["a", "b"])
def test_chunk_size_histogram_matches(built, tag):
    hists = [report(built, pkg, tag)["histograms"].get(
        "makisu_chunk_size_bytes") for pkg in PKGS]
    assert hists[0] == hists[1]
    assert (hists[0] is not None) == (tag == "a")


@pytest.mark.parametrize("tag", ["a", "b"])
def test_span_names_and_phases_match(built, tag):
    reps = [report(built, pkg, tag) for pkg in PKGS]
    reps[1], removed = without_port_spans(reps[1])
    assert set(removed) == (set(metrics.PORT_SPANS) if tag == "a"
                            else {"kv_pull", "kv_push"})
    assert span_names(reps[0]) == span_names(reps[1])
    phases = [{p for p, t in traceexport.phase_totals(r).items() if t > 0}
              for r in reps]
    assert phases[0] == phases[1]
    if tag == "a":
        assert "hash" in phases[1]


@pytest.mark.parametrize("tag", ["a", "b"])
def test_event_sequences_match(built, tag):
    def shared(e):
        return not (e["type"] in ("span_start", "span_end")
                    and e["name"] in metrics.PORT_SPANS)

    seqs = [[e["type"] for e in jsonl(built / pkg / f"E{tag}.jsonl")
             if shared(e)] for pkg in PKGS]
    assert seqs[0] == seqs[1]
    assert seqs[1][0] == "build_start" and seqs[1][-1] == "build_end"


@pytest.mark.parametrize("tag", ["a", "b"])
def test_ledger_lines_match(built, tag):
    def stable(line):
        return {k: v for k, v in line.items() if k not in ("ts", "trace_id")}

    lines = [[stable(x) for x in jsonl(built / pkg / f"L{tag}.jsonl")]
             for pkg in PKGS]
    assert lines[0] == lines[1]
    verdicts = {(x.get("source"), x.get("verdict")) for x in lines[1]}
    if tag == "b":
        assert ("kv", "hit") in verdicts and ("kv", "miss") not in verdicts


def test_history_records_match(built):
    records = [jsonl(built / pkg / "H.jsonl") for pkg in PKGS]
    assert [len(r) for r in records] == [2, 2]
    for ref, port in zip(*records):
        assert set(ref) == set(port)
        for key in ("schema", "command", "exit_code", "cache", "mode",
                    "warm_mode"):
            assert port[key] == ref[key], key
        assert sum(port["bytes_hashed"].values()) == \
            sum(ref["bytes_hashed"].values())
        assert port["hasher"] == "gpu" and port["device_probe"] == "absent"


def test_port_device_counters_follow_its_ring(built):
    """On the CPU route: one dispatch observation per S1 launch (the
    log's span_launches), and the device H2D counter equals the
    sessions' h2d_bytes."""
    rep = report(built, "port", "a")
    commits = [line for line in jsonl(built / "port" / "loga")
               if line["msg"].startswith("committed layer")]
    assert commits
    [hist] = rep["histograms"]["makisu_device_dispatch_seconds"]
    assert hist["count"] == sum(c["span_launches"] for c in commits)
    h2d = sum(s["value"] for s in
              rep["counters"]["makisu_device_h2d_bytes_total"])
    assert h2d == sum(c["h2d_bytes"] for c in commits)
    layer_bytes = sum(s["value"] for s in
                      rep["counters"]["makisu_gear_scan_bytes_total"])
    assert h2d <= 1.01 * layer_bytes
    assert "makisu_device_dispatch_seconds" not in \
        report(built, "port", "b")["histograms"]


def test_build_telemetry_line_matches(built):
    lines = [[x for x in jsonl(built / pkg / "loga")
              if x["msg"] == "build telemetry"] for pkg in PKGS]
    [ref], [port] = lines
    # The port's chunk route is labelled by its device (cpu here); its
    # span seconds, device seconds, committed entries and chunk probes
    # are its own.
    assert set(port) == set(ref) | {"hashed_bytes_cpu", "span_seconds",
                                    "device_busy_seconds", "commit_entries",
                                    "chunk_probes"}
    for key in ("exit_code", "cache_hits", "cache_misses",
                "layers_committed", "hashed_bytes"):
        assert port[key] == ref[key], key


@pytest.mark.parametrize("tag", ["a", "b"])
def test_chunk_probes_on_the_line(built, tag):
    """``chunk_probes`` is the build's ``makisu_chunk_probes_total`` by
    route: on the cold build at least one answer for each chunk the
    index did not find memoized; the warm build indexes nothing."""
    [line] = [x for x in jsonl(built / "port" / f"log{tag}")
              if x["msg"] == "build telemetry"]
    counters = report(built, "port", tag)["counters"]
    series = counters.get(metrics.CHUNK_PROBES, [])
    assert line["chunk_probes"] == {
        s["labels"]["route"]: int(s["value"]) for s in series}
    assert set(line["chunk_probes"]) <= {"listing", "stat"}
    probes = sum(s["value"] for s in counters.get(
        "makisu_chunk_exists_prefetch_total", [])
        if s["labels"]["result"] == "probe")
    assert sum(line["chunk_probes"].values()) >= probes
    if tag == "a":
        assert probes > 0
    else:
        assert line["chunk_probes"] == {}


# -- each package reads the other's artifacts ------------------------------

def render(which, argv, capsys):
    main = cli.main if which == "port" else ref_cli.main
    code = main(argv)
    return code, capsys.readouterr().out


READERS = {
    "report": lambda d: ["report", str(d / "Ra.json"),
                         "--events", str(d / "Ea.jsonl")],
    "report_bundle": lambda d: ["report", str(d / "bundle.json")],
    "explain": lambda d: ["explain", str(d / "La.jsonl"),
                          "--metrics", str(d / "Ra.json")],
    "explain_baseline": lambda d: ["explain", str(d / "Lb.jsonl"),
                                   "--baseline", str(d / "La.jsonl")],
    "history": lambda d: ["history", str(d / "H.jsonl")],
    "profile": lambda d: ["profile", str(d / "Pa.json")],
    "doctor": lambda d: ["doctor", str(d / "bundle.json")],
}


@pytest.mark.parametrize("reader", sorted(READERS))
@pytest.mark.parametrize("producer", PKGS)
def test_readers_render_the_other_package(built, capsys, reader, producer):
    argv = READERS[reader](built / producer)
    texts = {}
    for which in PKGS:
        code, out = render(which, argv, capsys)
        assert code == 0, (which, out)
        texts[which] = out
    assert texts["port"] == texts["ref"]
    assert texts["port"].strip()


def test_report_hash_phase_on_the_cold_build(built, capsys):
    code, out = render("port", READERS["report"](built / "port"), capsys)
    assert code == 0
    assert float(out.split("hash=")[1].split("s")[0]) > 0


# -- isolation of the two packages in one process --------------------------


def _counts(m):
    rep = m.global_registry().report()
    return rep["counters"], rep["histograms"]


def test_a_port_build_leaves_the_reference_registry_alone(tmp_path):
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=5)
    (tmp_path / "root").mkdir()
    before = _counts(ref_metrics)
    mountinfo.set_mountpoints_for_testing(set())
    try:
        assert run_build("port", [
            "build", str(ctx), "-t", "iso/app:1", "--storage",
            str(tmp_path / "s"), "--root", str(tmp_path / "root")]) == 0
    finally:
        mountinfo.set_mountpoints_for_testing(None)
    assert _counts(ref_metrics) == before


def test_a_reference_build_leaves_the_port_registry_alone(tmp_path):
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=6)
    (tmp_path / "root").mkdir()
    before = _counts(metrics)
    ref_mountinfo.set_mountpoints_for_testing(set())
    try:
        assert run_build("ref", [
            "build", str(ctx), "-t", "iso/app:1", "--storage",
            str(tmp_path / "s"), "--root", str(tmp_path / "root")]) == 0
    finally:
        ref_mountinfo.set_mountpoints_for_testing(None)
    assert _counts(metrics) == before


# -- the CLI surface --------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--jax-profile", "d", "doctor", "--device"],
    ["--jax-profile", "d", "version"],
])
def test_unported_flags_are_argparse_errors(argv):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2


def _storage_dir_with_a_build(tmp_path):
    ctx = tmp_path / "ctx"
    make_context(ctx, seed=9)
    (tmp_path / "root").mkdir()
    storage = tmp_path / "s"
    mountinfo.set_mountpoints_for_testing(set())
    try:
        assert run_build("port", ["build", str(ctx), "-t", "st/app:1",
                                  "--storage", str(storage),
                                  "--root", str(tmp_path / "root")]) == 0
    finally:
        mountinfo.set_mountpoints_for_testing(None)
    # As if the build were a process of its own: its live chunk store
    # (which ``doctor --storage`` would report an LRU seed for) is gone.
    from makisu_tpu_torch.cache import chunks as chunks_mod
    with chunks_mod._serving_lock:
        chunks_mod._serving_stores.pop(
            os.path.realpath(storage / "chunks"), None)
    return str(storage)


@pytest.mark.parametrize("command", ["worker-storage-budget",
                                     "doctor-storage", "du"])
def test_storage_commands_run_as_the_reference(tmp_path, capsys,
                                               monkeypatch, command):
    """``worker --storage-budget``, ``doctor --storage`` and ``du``
    parse and do what the reference does: the worker's budget becomes
    every storage dir's default; ``du`` and ``doctor --storage`` print
    the reference's text over the same built storage dir."""
    if command == "worker-storage-budget":
        import threading

        from makisu_tpu_torch.storage import contentstore
        from makisu_tpu_torch.worker import WorkerClient
        monkeypatch.setattr(contentstore, "_config", {
            "budget_bytes": None, "remote_dir": None,
            "tenant_quota_bytes": None})
        monkeypatch.setenv("MAKISU_TPU_STORAGE_SCRUB_SECONDS", "0")
        # The worker sets the shared hash and turns recipe publishing on
        # for its process; both restored after the test.
        from makisu_tpu_torch.serve import server as serve_server
        monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")
        monkeypatch.setattr(serve_server, "_publishing",
                            serve_server._publishing)
        sock = str(tmp_path / "w.sock")
        codes = []
        thread = threading.Thread(target=lambda: codes.append(cli.main(
            ["worker", "--socket", sock, "--storage-budget", "10"],
            device="cpu")), daemon=True)
        thread.start()
        client = WorkerClient(sock)
        deadline = time.monotonic() + 60
        while not client.ready():
            assert time.monotonic() < deadline, "the worker never came up"
            time.sleep(0.05)
        try:
            assert contentstore.budget_bytes_for(str(tmp_path)) == 10 << 20
            storage = _storage_dir_with_a_build(tmp_path)
            budget = client.healthz()["storage"]["budget"]
            assert budget["budget_bytes"] == 0  # no dir registered yet
            assert client.build(["build", str(tmp_path / "ctx"), "-t",
                                 "st/app:1", "--hasher", "cpu",
                                 "--storage", storage, "--root",
                                 str(tmp_path / "root")]) == 0
            budget = client.healthz()["storage"]["budget"]
            assert budget["budget_bytes"] == 10 << 20
            assert 0 < budget["hot_bytes"] <= 10 << 20
        finally:
            client.exit()
            thread.join(timeout=30)
        assert codes == [0]
        return
    from makisu_tpu import cli as ref_cli
    storage = _storage_dir_with_a_build(tmp_path)
    argv = (["du", "--storage", storage] if command == "du"
            else ["doctor", "--storage", storage])
    capsys.readouterr()
    outs = []
    for pkg_cli in (cli, ref_cli):
        code = pkg_cli.main(argv)
        outs.append((code, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0 and "chunks" in outs[0][1]


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY f /f\n")
    (ctx / "f").write_bytes(b"x" * 5000)
    (tmp_path / "root").mkdir()
    mountinfo.set_mountpoints_for_testing(set())
    try:
        assert run_build("port", [
            "--torch-profile", str(tmp_path / "prof"), "build", str(ctx),
            "-t", "tp/app:1", "--storage", str(tmp_path / "s"),
            "--root", str(tmp_path / "root")]) == 0
    finally:
        mountinfo.set_mountpoints_for_testing(None)
    [trace] = (tmp_path / "prof").glob("torch-profile-*.json")
    doc = json.loads(trace.read_text())
    assert doc["traceEvents"]


def test_a_long_native_commit_is_progress_not_a_stall(tmp_path):
    """One 256 MiB file commits through the native sink, whose C++
    streams the content past ``write``: the sink stamps the progress
    clock once per tap piece and once per file, so a commit longer than
    the stall window (``--stall-timeout 2``) dumps no ``stall`` bundle."""
    # The chunker package imports torch on a build's first use, about
    # 2 s here: imported before the build, so the window times the
    # commit under test, not that import.
    import torch  # noqa: F401
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY big.bin /big.bin\n")
    block = np.random.default_rng(8).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    with open(ctx / "big.bin", "wb") as f:
        for _ in range(256):
            f.write(block)
    (tmp_path / "root").mkdir()
    bundle = tmp_path / "stall.json"
    mountinfo.set_mountpoints_for_testing(set())
    mgr = session.SessionManager()
    token = session.bind_manager(mgr)
    try:
        code = cli.main([
            "--log-fmt", "json", "--log-output", str(tmp_path / "log"),
            "--events-out", str(tmp_path / "E.jsonl"),
            "--diag-out", str(bundle), "--stall-timeout", "2",
            "build", str(ctx), "-t", "big/app:1",
            "--storage", str(tmp_path / "s"),
            "--root", str(tmp_path / "root"), "--hasher", "cpu"],
            device="cpu")
    finally:
        session.reset_manager(token)
        mgr.reset()
        mountinfo.set_mountpoints_for_testing(None)
    assert code == 0
    assert '"sink": "native"' in (tmp_path / "log").read_text()
    types = [json.loads(line)["type"]
             for line in (tmp_path / "E.jsonl").read_text().splitlines()]
    assert "stall" not in types
    assert not bundle.exists()
