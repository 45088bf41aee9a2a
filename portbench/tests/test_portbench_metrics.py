"""The metric readers on recorded logs and a synthetic trace; every metric
in BENCHMARK.json, and of the cell it leaves out, has a reader that
returns None where it finds nothing to read."""

import pathlib

import pytest

from portbench import devtrace, harness, logphases

DATA = pathlib.Path(__file__).resolve().parent / "data"
BENCH = harness.load_bench(DATA / "left_out.json")


def reader(name: str):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py").read


def build_record(log: str) -> dict:
    records = logphases.read_log(str(DATA / log))
    start = records[0]["ts"] - 0.25
    return {"log": records, "start": start, "end": records[-1]["ts"],
            **logphases.phases(records, start)}


def run_of(records, trace=None, card=None, window_s=10.0):
    return harness.Run("cell", {}, {}, 12.5, window_s, records, trace, card)


def test_phases_of_a_recorded_cold_build():
    rec = build_record("cold_log.jsonl")
    assert rec["committed"] == 2 and rec["hits"] == 0
    assert rec["plan_s"] == pytest.approx(0.25 + 0.005, abs=1e-3)
    assert rec["commit_s"] == pytest.approx(7.172531717 + 5.502310642,
                                            rel=1e-6)
    assert rec["index_s"] == pytest.approx((1792293388.839 - 1792293388.821)
                                           + (1792293394.37
                                              - 1792293394.364), abs=2e-3)
    assert rec["bytes_total"] == 2 * 911360
    assert rec["bytes_added"] == 911360 + 15784


def test_phases_of_a_recorded_edit_build():
    rec = build_record("edit_log.jsonl")
    assert rec["committed"] == 1 and rec["hits"] == 1
    assert rec["apply_s"] == pytest.approx(1792294636.7823
                                           - 1792294636.777164, abs=1e-4)
    labels = {lab for lab, _, _ in logphases.intervals(
        rec["log"], rec["start"], rec["end"])}
    assert "build: apply a cached layer" in labels
    assert "build: layer commit (diff, sink, session)" in labels


def test_build_readers():
    cold = build_record("cold_log.jsonl")
    edit = build_record("edit_log.jsonl")
    run = run_of([cold, edit], window_s=8.0)
    assert reader("build_s")(run) == 4.0
    assert reader("plan.plan_s")(run) == pytest.approx(
        (cold["plan_s"] + edit["plan_s"]) / 2)
    assert reader("snapshot.commit_s")(run) == pytest.approx(
        (cold["commit_s"] + edit["commit_s"]) / 2)
    assert reader("chunkstore.index_s")(run) == pytest.approx(
        (cold["index_s"] + edit["index_s"]) / 2)
    assert reader("cache.apply_s")(run) == pytest.approx(edit["apply_s"])
    added = cold["bytes_added"] + edit["bytes_added"]
    total = cold["bytes_total"] + edit["bytes_total"]
    assert reader("chunkstore.added_pct")(run) == pytest.approx(
        100 * added / total)
    assert reader("setup_s")(run) == 12.5
    assert reader("commit_GBps")(run) is None
    assert reader("cache.apply_s")(run_of([cold])) is None


def synthetic_trace() -> list[dict]:
    """A window of 1 s (trace us 1000-1001000) with two G1 launches, one S1
    launch and a copy, overlapping in part."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
         "ts": 1000, "dur": 1_000_000},
        {"ph": "X", "cat": "kernel", "name": "gear_bitmap_kernel(x)",
         "ts": 2000, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "gear_bitmap_kernel(x)",
         "ts": 502000, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 502050, "dur": 150},
        {"ph": "X", "cat": "kernel", "name": "sha256_spans_kernel<int>(y)",
         "ts": 900000, "dur": 2000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
         "ts": 3000, "dur": 5000},
    ]


def test_trace_reduction_and_trace_readers():
    host = [("commit: tar write", 100.0, 100.6), ("commit: finish",
                                                  100.6, 101.0)]
    trace = devtrace.reduce_events(synthetic_trace(), 100.0, host)
    assert trace.window_s == pytest.approx(1.0)
    assert trace.busy_s == pytest.approx((100 + 200 + 2000) / 1e6)
    assert trace.op_seconds("gear_bitmap_kernel") == (pytest.approx(2e-4), 2)
    gaps = trace.gaps
    assert gaps["commit: tar write"] == pytest.approx(0.6 - 0.0003, abs=1e-6)
    assert sum(gaps.values()) == pytest.approx(1.0 - trace.busy_s)
    out = trace.breakdown()
    assert out["device_ops"][0][0] == "sha256_spans_kernel<int>(y)"
    assert out["idle_gaps"][0][0] == "commit: tar write"

    class Commit:
        chunks = [type("C", (), {"length": n})() for n in (8192, 4000)]

    rec = {"tar_bytes": 12192, "commit": Commit(), "compress_s": 0.5,
           "session_host_s": 0.25}
    card = {"sms": 132, "sm_hz": 1.98e9}
    run = run_of([rec], trace, card, window_s=1.0)
    gear = reader("gear_roofline")(run)
    sha = reader("sha256_roofline")(run)
    assert 0 < gear < 100 and 0 < sha < 100
    assert reader("device.idle_pct.commit")(run) == pytest.approx(
        100 * (1 - trace.busy_s))
    gib = 12192 / (1 << 30)
    assert reader("sink.compress_s")(run) == pytest.approx(0.5 / gib)
    assert reader("session.host_s")(run) == pytest.approx(0.25 / gib)
    assert reader("commit_GBps")(run) == pytest.approx(12192 / 1e9)
    assert reader("gear_roofline")(run_of([rec], trace)) is None


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]
                                    if m["name"] != "setup_s"])
def test_every_reader_finds_nothing_in_an_empty_run(metric):
    assert reader(metric)(run_of([])) is None
