"""The port's own spans (``metrics.PORT_SPANS``) in a build's tree, the
"build telemetry" line's ``span_seconds`` and ``device_busy_seconds``,
and the span mirror into torch's profiler.

A small context is built cold through ``makisu_tpu_torch.cli.main(...,
"--hasher", "gpu"], device="cpu")``, once against the storage's file KV
and once against the in-process HTTP KV (``fleet/kv.py``): each part of
the layer commit nests in ``commit_layer``, the chunk index in ``step``,
each KV GET in ``pull_cache_layers`` and each KV SET (on the push
thread, which carries the build's context) in ``step``. A build under
``--torch-profile`` holds every port span as a ``user_annotation``
event, the commit's parts inside ``commit_layer``'s; with no profiler
recording, the mirror opens nothing."""

import json

import numpy as np
import pytest
import torch

from makisu_tpu_torch import cli
from makisu_tpu_torch.fleet.kv import SharedKVServer
from makisu_tpu_torch.ops import backend
from makisu_tpu_torch.utils import metrics, mountinfo, traceexport
from makisu_tpu_torch.worker import session

DOCKERFILE = "FROM scratch\nCOPY app /app/\nCOPY app/f0.bin /x.bin\n"
# Where each port span nests.
PARENTS = {"commit.diff": "commit_layer",
           "commit.mtime_wait": "commit_layer",
           "commit.tar_write": "commit_layer",
           "commit.sink_finish": "commit_layer",
           "index_layer": "step",
           "kv_pull": "pull_cache_layers",
           "kv_push": "step"}


def make_context(path, sizes=(3000, 7000)):
    rng = np.random.default_rng(11)
    (path / "app").mkdir(parents=True)
    for k, size in enumerate(sizes):
        (path / "app" / f"f{k}.bin").write_bytes(
            rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    (path / "Dockerfile").write_text(DOCKERFILE)


def build(tmp, ctx, top=(), flags=()):
    """One cold build of ``ctx`` with a fresh session manager, ``top``
    the global flags and ``flags`` the build's; returns its report and
    its log records."""
    (tmp / "root").mkdir()
    mountinfo.set_mountpoints_for_testing(set())
    mgr = session.SessionManager()
    token = session.bind_manager(mgr)
    try:
        code = cli.main([
            "--log-fmt", "json", "--log-output", str(tmp / "log"),
            "--metrics-out", str(tmp / "R.json"), *top,
            "build", str(ctx), "-t", "spans/app:1",
            "--storage", str(tmp / "s"), "--root", str(tmp / "root"),
            "--hasher", "gpu", *flags], device="cpu")
    finally:
        session.reset_manager(token)
        mgr.reset()
        mountinfo.set_mountpoints_for_testing(None)
    assert code == 0
    records = [json.loads(line)
               for line in (tmp / "log").read_text().splitlines()]
    return json.loads((tmp / "R.json").read_text()), records


def walk(span, parent=None):
    yield span, parent
    for child in span.get("children", []):
        yield from walk(child, span)


@pytest.fixture(scope="module", params=["fs", "http"])
def built(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"spans-{request.param}")
    make_context(tmp / "ctx")
    if request.param == "fs":
        return build(tmp, tmp / "ctx")
    server = SharedKVServer()
    addr = server.start()
    try:
        return build(tmp, tmp / "ctx", flags=("--http-cache-addr", addr))
    finally:
        server.stop()


def test_port_spans_nest_under_their_parents(built):
    report, _ = built
    seen = {}
    for top in report["spans"]:
        for span, parent in walk(top):
            if span["name"] in metrics.PORT_SPANS:
                seen.setdefault(span["name"], set()).add(parent["name"])
                assert span["parent_id"] == parent["span_id"]
                assert span["duration"] is not None
    assert seen == {name: {PARENTS[name]} for name in metrics.PORT_SPANS}


def test_port_spans_keep_their_parents_phases():
    """A port span takes its time from its parent's self time, so it
    falls in its parent's phase; the KV SET runs on the push thread,
    which ``wait_for_push`` joins, and falls in its phase."""
    for name, parent in PARENTS.items():
        want = "push" if name == "kv_push" else traceexport.phase_of(parent)
        assert traceexport.phase_of(name) == want, name
    assert traceexport.phase_of("wait_for_push") == "push"


def test_build_telemetry_line_carries_span_seconds(built):
    report, records = built
    [line] = [r for r in records if r["msg"] == "build telemetry"]
    want = {}
    for top in report["spans"]:
        for span, _ in walk(top):
            want[span["name"]] = want.get(span["name"], 0.0) \
                + span["duration"]
    assert set(line["span_seconds"]) == set(want)
    for name, seconds in want.items():
        assert line["span_seconds"][name] == pytest.approx(seconds,
                                                           abs=1e-5)
    assert set(metrics.PORT_SPANS) <= set(line["span_seconds"])
    # The CPU route records no device time.
    assert line["device_busy_seconds"] == 0
    commits = [r for r in records if r["msg"].startswith("committed layer")]
    assert len(commits) == 2
    assert all(r["device_s"] == 0 for r in commits)
    # The wait is the part of the os.sync and wait that sync_s times.
    assert 0 < line["span_seconds"]["commit.mtime_wait"] <= sum(
        r["sync_s"] for r in commits)


def test_build_telemetry_line_counts_the_committed_entries(built):
    """``commit_entries`` on the line is the build's total of the counter
    ``makisu_commit_entries_total``: every entry of both layers."""
    report, records = built
    [line] = [r for r in records if r["msg"] == "build telemetry"]
    created = [int(r["msg"].split()[3]) for r in records
               if r["msg"].startswith("created copy layer")]
    assert len(created) == 2
    assert line["commit_entries"] == sum(created)
    assert sum(s["value"] for s in report["counters"][
        metrics.COMMIT_ENTRIES]) == sum(created)


def test_the_commit_diff_is_a_port_span_of_the_commit_phase():
    assert "commit.diff" in metrics.PORT_SPANS
    assert traceexport.phase_of("commit.diff") == \
        traceexport.phase_of("commit_layer") == \
        traceexport.phase_of("commit.tar_write")


def test_torch_profile_holds_the_port_spans(tmp_path):
    """Every port span is a ``user_annotation`` of the ``--torch-profile``
    trace (the push thread's too), and each part of a commit lies inside
    a ``commit_layer`` annotation."""
    make_context(tmp_path / "ctx", sizes=(5000,))
    build(tmp_path, tmp_path / "ctx",
          top=("--torch-profile", str(tmp_path / "prof")))
    [trace] = (tmp_path / "prof").glob("torch-profile-*.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    names = {e["name"] for e in events}
    assert set(metrics.PORT_SPANS) <= names
    commits = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e["name"] == "commit_layer"]
    assert commits
    for e in events:
        if e["name"].startswith("commit."):
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                       for a, b in commits), e["name"]


def test_span_mirror_opens_nothing_without_a_profiler():
    assert backend._profiler_span("commit.tar_write") is None
    opened = []

    def counting(name):
        scope = backend._profiler_span(name)
        if scope is not None:
            opened.append(name)
        return scope

    previous = metrics.set_span_mirror(counting)
    try:
        with metrics.span("outside"):
            pass
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with metrics.span("inside"):
                pass
        with metrics.span("after"):
            pass
    finally:
        assert metrics.set_span_mirror(previous) is counting
    assert opened == ["inside"]
