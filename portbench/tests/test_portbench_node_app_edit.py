"""The cell ``node-app.edit`` and its five readers.

The cell runs on the configuration ``node-app``
(``configs/node-app-256mib.json``: config 3 with ``context_bytes`` cut
to 256 MiB). ``data/left_out.json`` keeps a configuration of the same
name for the left-out ``node-app.commit``, on ``configs/node-app.json``
(1 GiB); the two files differ only in ``context_bytes`` and ``reduced``,
and the cell's traffic sets ``context_bytes`` itself, so a bench that
merges both runs the cell the same on either.

Whole runs of the harness on the program's plain (``device="cpu"``)
path at a small ``context_bytes``: a sound run is correct, and a run
with a chunk's digest flipped where the session makes it is not. The
readers ``snapshot.diff_s``, ``snapshot.entries_per_s``,
``sink.compress_s.build``, ``gear_roofline.build`` and
``sha256_roofline.build`` on a recorded build of the cell
(``data/node_app_edit_log.jsonl``: one window build's log of
``node-app.edit`` on an NVIDIA H100), with a synthetic trace and a file
KV that lists the build's layer; each returns None where what it reads
is absent, as in a build of a program without the span and the counter."""

import json
import pathlib
import sys

import pytest

from portbench import devtrace, harness, logphases

DATA = pathlib.Path(__file__).resolve().parent / "data"
CELL = "node-app.edit"
SPAN_READERS = ("snapshot.diff_s", "snapshot.entries_per_s")
ROOFLINES = ("gear_roofline.build", "sha256_roofline.build")
READERS = SPAN_READERS + ("sink.compress_s.build",) + ROOFLINES
CARD = {"sms": 132, "sm_hz": 1.98e9}


@pytest.fixture(autouse=True)
def no_mount_table():
    """Builds in a temp dir under a mount would skip its files."""
    from makisu_tpu_torch.utils import mountinfo
    mountinfo.set_mountpoints_for_testing(set())
    yield
    mountinfo.set_mountpoints_for_testing(None)


def run_cell(capsys, trace=0) -> dict | None:
    rc = harness.main(["--workload", CELL, "--seed", "4294967311",
                       "--seconds", "0.1", "--trace", str(trace)],
                      device="cpu",
                      overrides={"traffic": {"context_bytes": 1 << 20}})
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    if rc != 0:
        print(captured.err, file=sys.stderr)  # shown if the test fails
        assert not out or not out[-1].startswith("{")
        return None
    return json.loads(out[-1])


ACCEPTED = ("build_s", "plan.plan_s", "snapshot.commit_s",
            "chunkstore.index_s", "chunkstore.added_pct",
            "device.idle_pct.build", "snapshot.mtime_wait_s",
            "snapshot.tar_write_s", "snapshot.sink_finish_s",
            "chunkstore.chunk_index_s", "cache.kv_s",
            "device.busy_ms.build")


def test_the_cell_is_in_the_benchmark_as_given():
    bench = harness.load_bench()
    for key in ("configs", "workloads"):
        names = [e["name"] for e in bench[key]]
        assert len(names) == len(set(names)), key
    [cell] = [w for w in bench["workloads"] if w["name"] == CELL]
    [config] = [c for c in bench["configs"] if c["name"] == "node-app"]
    assert cell["chips"] == 1 and cell["config"] == "node-app"
    assert config["reduced"] == ["context_bytes"]
    traffic = json.loads((harness.PKG / "cells" / f"{CELL}.json")
                         .read_text())
    cfg = json.loads((harness.ROOT / config["file"]).read_text())
    assert traffic["context_bytes"] == cfg["context_bytes"] == 256 << 20
    assert cfg["kv"] is None and cfg["name"] == "node-app"
    assert traffic["build_flags"] == ["--compression", "speed",
                                      "--gzip-backend", "pgzip"]
    assert traffic["expect"] == {"committed": 1, "hits": 0}
    reported = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert set(READERS) | set(ACCEPTED[1:]) == reported
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} \
        == {"build_s", "setup_s"}
    for name in READERS:
        [m] = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL]
        assert (harness.PKG / "metrics" / f"{name}.py").exists()


def test_the_left_out_namesake_runs_the_cell_the_same():
    """``left_out.json``'s ``node-app`` differs from the cell's own file
    only in what the cell's traffic overrides or only records."""
    [left] = [c for c in json.loads((DATA / "left_out.json").read_text())
              ["configs"] if c["name"] == "node-app"]
    [own] = [c for c in harness.load_bench()["configs"]
             if c["name"] == "node-app"]
    a, b = (json.loads((harness.ROOT / c["file"]).read_text())
            for c in (left, own))
    assert {k for k in a.keys() | b.keys() if a.get(k) != b.get(k)} \
        == {"context_bytes", "reduced"}
    merged = harness.load_bench(DATA / "left_out.json")
    assert CELL in {w["name"] for w in merged["workloads"]}


def test_a_sound_run_is_correct(capsys):
    result = run_cell(capsys, trace=1)
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    # On the CPU there is no card: the span and counter readers read,
    # the rooflines find no device trace to read.
    for name in SPAN_READERS + ("sink.compress_s.build",):
        assert result["metrics"][name]["value"] > 0, name
    assert not set(ROOFLINES) & set(result["metrics"])


def test_a_flipped_chunk_digest_is_not_correct(capsys, monkeypatch):
    from makisu_tpu_torch.chunker import cdc
    finish = cdc.ChunkSession.finish

    def broken(self):
        chunks = finish(self)
        c = chunks[-1]
        chunks[-1] = cdc.Chunk(c.offset, c.length,
                               c.digest[:-1] + bytes([c.digest[-1] ^ 1]))
        return chunks

    monkeypatch.setattr(cdc.ChunkSession, "finish", broken)
    result = run_cell(capsys)
    assert result is None or result["correct"] is False


def reader(name: str):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py").read


def recorded() -> list[dict]:
    return logphases.read_log(str(DATA / "node_app_edit_log.jsonl"))


def telemetry(records) -> dict:
    [line] = [r for r in records if r["msg"] == "build telemetry"]
    return line


def committed(records) -> dict:
    [rec] = [r for r in records if r["msg"].startswith("committed layer ")]
    return rec


def build_record(records, storage="") -> dict:
    start = records[0]["ts"] - 0.25
    return {"log": records, "start": start, "end": records[-1]["ts"],
            "storage": storage, **logphases.phases(records, start)}


def file_kv(storage: pathlib.Path, records) -> list[int]:
    """A file KV that lists the recorded layer under its gzip digest, with
    as many chunks as the build committed, tiling its tar bytes; returns
    the chunk lengths."""
    commit = committed(records)
    [indexed] = [r for r in records if r["msg"].startswith("indexed ")]
    n, total = commit["msg"].split()[-2], indexed["bytes_total"]
    n = int(n.lstrip("("))
    lengths = [total // n] * (n - 1)
    lengths.append(total - sum(lengths))
    chunks, off = [], 0
    for k, length in enumerate(lengths):
        chunks.append([off, length, f"{k:064x}"])
        off += length
    entry = {"gzip": commit["msg"].split()[2], "gz": "pgzip-1-131072",
             "tar": "sha256:" + "0" * 64, "chunks": chunks}
    storage.mkdir(exist_ok=True)
    (storage / "cache_key_value.json").write_text(json.dumps(
        {"other": ["not a layer", 0], "layer": [json.dumps(entry), 0]}))
    return lengths


def window_trace(g1_s: float, s1_s: float):
    events = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
               "ts": 0, "dur": 10_000_000},
              {"ph": "X", "cat": "kernel", "name": "gear_bitmap_kernel(x)",
               "ts": 1000, "dur": g1_s * 1e6},
              {"ph": "X", "cat": "kernel",
               "name": "sha256_spans_kernel<int>(y)", "ts": 500_000,
               "dur": s1_s * 1e6}]
    return devtrace.reduce_events(events, 0.0, [])


def run_of(recs, trace=None, card=None):
    return harness.Run(CELL, {}, {}, 30.0, 8.0, list(recs), trace, card)


def test_the_five_readers_on_a_recorded_build(tmp_path):
    records = recorded()
    line, commit = telemetry(records), committed(records)
    lengths = file_kv(tmp_path / "s", records)
    rec = build_record(records, str(tmp_path / "s"))
    from portbench import peaks
    rate = peaks.int32_ops_per_s(CARD["sms"], CARD["sm_hz"])
    gear_least, _ = peaks.gear_bound_s(sum(lengths), rate)
    blocks = sum((n + 9 + 63) // 64 for n in lengths)
    sha_least, _ = peaks.sha_bound_s(sum(lengths), len(lengths), blocks,
                                     rate)
    run = run_of([rec, rec], window_trace(4 * gear_least, 8 * sha_least),
                 CARD)
    assert reader("snapshot.diff_s")(run) == pytest.approx(
        line["span_seconds"]["commit.diff"])
    assert reader("snapshot.entries_per_s")(run) == pytest.approx(
        line["commit_entries"] / line["span_seconds"]["commit.tar_write"])
    assert reader("sink.compress_s.build")(run) == pytest.approx(
        commit["compress_s"] / (rec["bytes_total"] / (1 << 30)))
    # Two builds' streams in the window over the launches' time.
    assert reader("gear_roofline.build")(run) == pytest.approx(
        100 * 2 * gear_least / (4 * gear_least), rel=1e-3)
    assert reader("sha256_roofline.build")(run) == pytest.approx(
        100 * 2 * sha_least / (8 * sha_least), rel=1e-3)
    # The file KV's GET and SET (no Redis in this cell).
    assert reader("cache.kv_s")(run) == pytest.approx(
        line["span_seconds"]["kv_pull"] + line["span_seconds"]["kv_push"])
    assert commit["span_launches"] > 1
    assert line["commit_entries"] > 10_000


def test_the_readers_find_nothing_in_a_build_without_the_span(tmp_path):
    """A build of a program that opens no ``commit.diff`` and counts no
    entries; a run with no trace, no card, or no KV entry of the layer."""
    records = recorded()
    line = telemetry(records)
    del line["span_seconds"]["commit.diff"]
    del line["commit_entries"]
    file_kv(tmp_path / "s", records)
    rec = build_record(records, str(tmp_path / "s"))
    trace = window_trace(0.01, 0.01)
    for name in SPAN_READERS:
        assert reader(name)(run_of([rec], trace, CARD)) is None, name
    assert reader("sink.compress_s.build")(run_of([rec])) > 0
    for name in ROOFLINES:
        assert reader(name)(run_of([rec], trace, CARD)) > 0
        assert reader(name)(run_of([rec], None, CARD)) is None
        assert reader(name)(run_of([rec], trace, None)) is None
        assert reader(name)(run_of([build_record(
            records, str(tmp_path / "empty"))], trace, CARD)) is None
    for name in READERS:
        assert reader(name)(run_of([])) is None, name
        assert reader(name)(run_of([{"log": []}], trace, CARD)) is None


def test_the_data_file_is_one_window_builds_log():
    records = recorded()
    assert records[-1]["msg"] == "build telemetry"
    assert [r["msg"].split()[0] for r in records].count("committed") == 1
    assert not any(r["msg"].startswith("applying cached layer")
                   for r in records)
    assert {"commit.diff", "commit.tar_write"} <= set(
        telemetry(records)["span_seconds"])
