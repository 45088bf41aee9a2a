"""Config 3's edit rebuild through the port's CLI, on the kernels' plain
versions (``device="cpu"``).

A small node_modules-heavy app (``portbench.gen.layer_files``, the
benchmark's configuration ``node-app`` at ~2 MiB) is built cold through
``makisu_tpu_torch.cli.main(["build", ..., "--hasher", "gpu",
"--compression", "speed", "--gzip-backend", "pgzip"])`` into a storage
with its file KV; 16 bytes are then appended to 1% of its files and it
is built again into a fresh root and the same storage. The rebuild misses
the layer cache, recommits the one layer, and indexes only a small share
of new chunk bytes. Its tar, its pgzip blob and its KV chunk list (the
cut ends and every chunk's SHA-256) equal what ``portbench/reference/``
works out from the context alone, and its "build telemetry" line carries
the span ``commit.diff`` and the count of entries committed. Each commit
route (the copy-op diff and the scan) opens ``commit.diff`` once around
its diff and counts the layer's entries, and its walk's stat is the
only one an entry costs."""

import gzip
import io
import json
import os
import pathlib
import shutil
import tarfile

import pytest

from makisu_tpu_torch import cli
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.snapshot.copy_op import CopyOperation
from makisu_tpu_torch.utils import metrics, mountinfo
from makisu_tpu_torch.worker import session
from portbench import gen
from portbench.reference import judge, layers

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = dict(json.loads(
    (ROOT / "portbench" / "configs" / "node-app-256mib.json").read_text()),
    context_bytes=2 << 20)
FLAGS = ("--compression", "speed", "--gzip-backend", "pgzip")
SEED = 2147483659


def build(tmp, name, ctx, storage):
    """One build of ``ctx`` into a fresh root and ``storage``, with a
    fresh session manager; returns its log records and its manifest."""
    root, log = tmp / f"root-{name}", tmp / f"log-{name}"
    root.mkdir()
    mountinfo.set_mountpoints_for_testing(set())
    mgr = session.SessionManager()
    token = session.bind_manager(mgr)
    try:
        code = cli.main([
            "--log-fmt", "json", "--log-output", str(log), "build",
            str(ctx), "-t", f"node/app:{name}", "--hasher", "gpu",
            "--storage", str(storage), "--root", str(root), *FLAGS],
            device="cpu")
    finally:
        session.reset_manager(token)
        mgr.reset()
        mountinfo.set_mountpoints_for_testing(None)
    assert code == 0
    records = [json.loads(line) for line in log.read_text().splitlines()]
    manifest = json.loads(
        (storage / "manifests" / "node" / "app" / f"{name}.json")
        .read_text())
    return records, manifest


@pytest.fixture(scope="module")
def rebuilt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("node-app")
    ctx, storage = tmp / "ctx", tmp / "storage"
    files = gen.context_files(CONFIG, SEED)
    dockerfile = gen.dockerfile(CONFIG)
    gen.write_context(str(ctx), files, dockerfile)
    cold, _ = build(tmp, "1", ctx, storage)
    picked = gen.append_to_one_percent(str(ctx / "app"), [SEED, 1])
    records, manifest = build(tmp, "2", ctx, storage)
    want = dict(files)
    for rel in picked:
        want[f"app/{rel}"] += gen.EDIT_BYTES
    want["Dockerfile"] = dockerfile.encode()
    [desc] = manifest["layers"]
    hexd = desc["digest"].split(":")[1]
    blob = (storage / "layers" / hexd[:2] / hexd).read_bytes()
    kv = json.loads((storage / "cache_key_value.json").read_text())
    entries = [json.loads(v) for v, _ in kv.values() if v.startswith("{")]
    [entry] = [e for e in entries if e["gzip"] == desc["digest"]]
    return {"cold": cold, "records": records, "manifest": manifest,
            "picked": picked, "want": want, "dockerfile": dockerfile,
            "blob": blob, "entry": entry, "files": files}


def record(records, prefix):
    return [r for r in records if r["msg"].startswith(prefix)]


def test_the_edit_touches_one_percent_of_the_app(rebuilt):
    app = [p for p, _ in rebuilt["files"] if p.startswith("app/")]
    assert len(app) > 40
    assert len(rebuilt["picked"]) == max(1, len(app) // 100)


def test_the_rebuild_misses_and_adds_few_chunk_bytes(rebuilt):
    recs = rebuilt["records"]
    assert len(record(recs, "committed layer ")) == 1
    assert not record(recs, "applying cached layer")
    [line] = record(recs, "build telemetry")
    assert line["cache_hits"] == 0 and line["layers_committed"] == 1
    [indexed] = record(recs, "indexed ")
    [cold] = record(rebuilt["cold"], "indexed ")
    assert cold["bytes_added"] > 0.5 * cold["bytes_total"]
    assert 0 < indexed["bytes_added"] < 0.1 * indexed["bytes_total"]
    [commit] = record(recs, "committed layer ")
    assert commit["sink"] == "native"
    assert commit["compress_workers"] >= 1


def test_the_rebuilt_layer_equals_the_reference(rebuilt):
    blob, entry = rebuilt["blob"], rebuilt["entry"]
    [desc] = rebuilt["manifest"]["layers"]
    tar = gzip.decompress(blob)
    assert "sha256:" + layers.sha256_hex(blob) == desc["digest"]
    assert "sha256:" + layers.sha256_hex(tar) == entry["tar"]
    [want] = layers.copy_layers(rebuilt["dockerfile"], rebuilt["want"])
    assert layers.file_mismatches(layers.regular_files(tar), want) == 0
    assert entry["gz"].startswith("pgzip-1-")
    assert blob == layers.blob_for(tar, entry["gz"])
    chunks = [tuple(c) for c in entry["chunks"]]
    got = judge.chunk_counts(tar, chunks, judge.want_ends(
        tar, CONFIG["chunking"], "cpu"))
    assert got == {"cut_ends": 0, "chunk_digests": 0, "untiled": 0}


def test_the_telemetry_line_carries_the_diff_and_the_entries(rebuilt):
    recs = rebuilt["records"]
    [line] = record(recs, "build telemetry")
    [commit] = record(recs, "committed layer ")
    assert 0 < line["span_seconds"]["commit.diff"] <= commit["commit_s"]
    assert line["span_seconds"]["commit.diff"] == pytest.approx(
        commit["diff_s"], abs=5e-3)
    with tarfile.open(fileobj=io.BytesIO(gzip.decompress(rebuilt["blob"])),
                      mode="r:") as tf:
        members = tf.getmembers()
    [created] = record(recs, "created copy layer")
    assert line["commit_entries"] == len(members) == int(
        created["msg"].split()[3])


def commit_route(tmp_path, route):
    """The app of a 64 KiB context committed by ``route``: the copy-op
    route diffs a copy operation from the context; the scan route diffs
    the root as a RUN step left it. Returns the files, the MemFS, the
    layer and the build registry."""
    ctx, root = tmp_path / "ctx", tmp_path / "root"
    files = gen.context_files(dict(CONFIG, context_bytes=64 << 10), SEED)
    gen.write_context(str(ctx), files, "")
    os.remove(ctx / "Dockerfile")
    root.mkdir()
    if route == "scan":
        shutil.copytree(ctx / "app", root / "app")
    mountinfo.set_mountpoints_for_testing(set())
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        fs = memfs.MemFS(str(root))
        with tarfile.open(fileobj=io.BytesIO(), mode="w|") as tw:
            if route == "scan":
                layer = fs.add_layer_by_scan(tw)
            else:
                layer = fs.add_layer_by_copy_ops([CopyOperation(
                    ["app/"], str(ctx), "/", "/app/",
                    chown=f"{os.getuid()}:{os.getgid()}")], tw)
    finally:
        metrics.reset_build_registry(token)
        mountinfo.set_mountpoints_for_testing(None)
    return files, fs, layer, reg


@pytest.mark.parametrize("route", ["copy", "scan"])
def test_each_commit_route_spans_its_diff_and_counts_entries(tmp_path,
                                                            route):
    files, fs, layer, reg = commit_route(tmp_path, route)
    assert {f"/{p}" for p, _ in files} <= set(layer.entries)
    diffs = [s for s in reg.report()["spans"] if s["name"] == "commit.diff"]
    [span] = diffs
    assert span["duration"] == pytest.approx(fs.diff_seconds, abs=5e-3)
    assert reg.counter_total(metrics.COMMIT_ENTRIES) == len(layer)


@pytest.mark.parametrize("route", ["copy", "scan"])
def test_each_commit_route_stats_an_entry_once(tmp_path, monkeypatch,
                                               route):
    """The header of each walked entry comes from the walk's own stat
    (the directory entry's): no second ``os.lstat`` of the file, which
    on a filesystem at ~0.1 ms a call is seconds for ~12k files."""
    real, seen = os.lstat, []

    def lstat(path, *a, **kw):
        seen.append(os.fspath(path))
        return real(path, *a, **kw)

    monkeypatch.setattr(os, "lstat", lstat)
    files, _, layer, _ = commit_route(tmp_path, route)
    assert len(files) >= 3
    walked = [p for p in seen
              if os.path.basename(p) in {os.path.basename(f)
                                         for f, _ in files}]
    assert walked == []
    assert {f"/{p}" for p, _ in files} <= set(layer.entries)
