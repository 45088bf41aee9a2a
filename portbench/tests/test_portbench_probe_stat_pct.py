"""The reader ``chunkstore.probe_stat_pct`` on recorded builds.

``data/node_app_edit_probes_log.jsonl`` is one window build's log of
``node-app.edit`` on an NVIDIA H100, by a program whose "build
telemetry" line carries ``chunk_probes`` (the chunk store's existence
answers by route, the counter ``makisu_chunk_probes_total``). The
recorded builds of a program without it (``data/node_app_edit_log.jsonl``
and ``data/edit_log_spans.jsonl``) read None."""

import json
import pathlib

import pytest

from portbench import harness, logphases

DATA = pathlib.Path(__file__).resolve().parent / "data"
NAME = "chunkstore.probe_stat_pct"
read = harness.load_module(harness.PKG / "metrics" / f"{NAME}.py").read


def build_record(log: str) -> dict:
    return {"log": logphases.read_log(str(DATA / log))}


def telemetry(rec: dict) -> dict:
    [line] = [r for r in rec["log"] if r["msg"] == "build telemetry"]
    return line


def run_of(records):
    return harness.Run("cell", {}, {}, 12.5, 10.0, records, None, None)


def test_a_recorded_build_with_chunk_probes():
    rec = build_record("node_app_edit_probes_log.jsonl")
    probes = telemetry(rec)["chunk_probes"]
    assert set(probes) == {"listing", "stat"}
    assert read(run_of([rec])) == pytest.approx(
        100 * probes["stat"] / (probes["listing"] + probes["stat"]))
    assert 0 < read(run_of([rec])) < 5


@pytest.mark.parametrize("log", ["node_app_edit_log.jsonl",
                                 "edit_log_spans.jsonl"])
def test_a_build_of_the_program_without_the_key_reads_none(log):
    rec = build_record(log)
    assert "chunk_probes" not in telemetry(rec)
    assert read(run_of([rec])) is None
    assert read(run_of([])) is None


def test_the_mean_counts_only_builds_that_gave_answers():
    with_probes = build_record("node_app_edit_probes_log.jsonl")
    line = telemetry(with_probes)
    other = json.loads(json.dumps(with_probes))
    telemetry(other)["chunk_probes"] = {"stat": 30, "listing": 70}
    idle = json.loads(json.dumps(with_probes))
    telemetry(idle)["chunk_probes"] = {}
    parent = build_record("node_app_edit_log.jsonl")
    first = 100 * line["chunk_probes"]["stat"] / sum(
        line["chunk_probes"].values())
    assert read(run_of([with_probes, other, idle, parent])) == \
        pytest.approx((first + 30.0) / 2)
    assert read(run_of([idle, parent])) is None


def test_the_metric_is_in_the_benchmark_as_given():
    bench = harness.load_bench()
    [m] = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "%", "better": "lower",
                 "source": "program_counter", "layer": "chunk store",
                 "moves": "build_s",
                 "workloads": ["monorepo.edit", "node-app.edit"]}
    assert bench["per_layer"][-1] == m
    layers = {x["layer"] for x in bench["per_layer"]
              if x["name"].startswith("chunkstore.")}
    assert layers == {"chunk store"}
