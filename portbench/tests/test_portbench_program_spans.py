"""The readers of the program's own spans and device counter on a real
edit build's log (``data/edit_log_spans.jsonl``: ``monorepo.edit`` on an
NVIDIA H100, its "build telemetry" line with ``span_seconds`` and
``device_busy_seconds``); each returns None where the line lacks what
it reads, as a build of a program without them logs it."""

import json
import pathlib

import pytest

from portbench import harness, logphases

DATA = pathlib.Path(__file__).resolve().parent / "data"
SPANS = {"snapshot.mtime_wait_s": ("commit.mtime_wait",),
         "snapshot.tar_write_s": ("commit.tar_write",),
         "snapshot.sink_finish_s": ("commit.sink_finish",),
         "chunkstore.chunk_index_s": ("index_layer",),
         "cache.apply_layer_s": ("apply_layer",),
         "cache.kv_s": ("kv_pull", "kv_push")}
READERS = sorted(SPANS) + ["device.busy_ms.build"]


def reader(name: str):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py").read


def build_record(records: list[dict]) -> dict:
    start = records[0]["ts"] - 0.25
    return {"log": records, "start": start, "end": records[-1]["ts"],
            **logphases.phases(records, start)}


def recorded(log: str = "edit_log_spans.jsonl") -> list[dict]:
    return logphases.read_log(str(DATA / log))


def run_of(*recs):
    return harness.Run("monorepo.edit", {}, {}, 30.0, 8.0, list(recs))


def telemetry(records):
    [line] = [r for r in records if r["msg"] == "build telemetry"]
    return line


def test_the_seven_readers_on_a_real_build():
    records = recorded()
    line = telemetry(records)
    run = run_of(build_record(records))
    for name, spans in SPANS.items():
        assert reader(name)(run) == pytest.approx(
            sum(line["span_seconds"][s] for s in spans)), name
    assert reader("device.busy_ms.build")(run) == pytest.approx(
        1000 * line["device_busy_seconds"])


def test_the_program_spans_lie_inside_the_outside_phases():
    """On the recorded build: the commit's parts within its commit_s, the
    chunk index within the log's index interval, the hits' application
    within the log's apply interval, the wait within the sync."""
    rec = build_record(recorded())
    run = run_of(rec)
    parts = sum(reader(m)(run) for m in ("snapshot.mtime_wait_s",
                                         "snapshot.tar_write_s",
                                         "snapshot.sink_finish_s"))
    assert parts <= reader("snapshot.commit_s")(run)
    assert reader("chunkstore.chunk_index_s")(run) <= \
        reader("chunkstore.index_s")(run)
    assert reader("cache.apply_layer_s")(run) <= reader("cache.apply_s")(run)
    assert 0 < reader("snapshot.mtime_wait_s")(run) <= rec["sync_s"]


def test_the_mean_counts_only_builds_whose_line_holds_the_key():
    """A build of a program without the keys (the older recorded log)
    beside one with them: each reader reads the latter alone."""
    new, old = build_record(recorded()), build_record(
        recorded("edit_log.jsonl"))
    assert "span_seconds" not in telemetry(old["log"])
    for name in READERS:
        assert reader(name)(run_of(new, old)) == reader(name)(run_of(new))
        assert reader(name)(run_of(old)) is None, name


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_where_the_line_lacks_its_key(name):
    records = recorded()
    line = telemetry(records)
    if name == "device.busy_ms.build":
        del line["device_busy_seconds"]
    else:
        for span in SPANS[name]:
            del line["span_seconds"][span]
    assert reader(name)(run_of(build_record(records))) is None
    line.pop("span_seconds", None)
    line.pop("device_busy_seconds", None)
    assert reader(name)(run_of(build_record(records))) is None
    assert reader(name)(run_of({"log": []})) is None


def test_the_data_file_is_one_builds_log():
    lines = (DATA / "edit_log_spans.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    assert records[-1]["msg"] == "build telemetry"
    assert set(telemetry(records)["span_seconds"]) >= {
        s for spans in SPANS.values() for s in spans}
