"""One run of one benchmark cell of ``makisu_tpu_torch`` on one NVIDIA card.

The harness is driven by data. ``BENCHMARK.json`` names the cell, its
configuration and its metrics; everything else is found by name:

- ``portbench/cells/<cell>.json``: the cell's traffic mix (the entry it
  drives and that entry's parameters);
- the configuration's file (``configs`` in ``BENCHMARK.json``);
- ``portbench/entries/<entry>.py``: an ``Entry`` class that makes the
  inputs from the seed, runs one unit of work per call and judges the
  outputs against ``portbench/reference/``;
- ``portbench/metrics/<metric>.py``: a ``read(run)`` that returns the
  metric's value, or None where the run holds nothing to read.

A run: import torch, bring the device plane up (``backend_ready``), make
the inputs from ``--seed``, run one untimed warm-up iteration (all of it
``setup_s``), then iterate until ``--seconds`` have passed (an iteration
that starts before the deadline runs to its end and counts), read the
device's memory peak, judge the outputs and print one JSON line. With
``--trace 1`` the window runs under torch.profiler and the line carries
the per-layer metrics; with ``--trace 0``, the end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time
import traceback

from portbench import devtrace

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level module names that must not be loaded when the window closes:
# the JAX package (the reference this port was made from) and JAX itself.
BANNED_MODULES = ("jax", "jaxlib", "flax", "makisu_tpu")


@dataclasses.dataclass
class Context:
    """What an entry is given: the cell's data, the seed and a work dir."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    device: str          # "cuda" on the card; "cpu" in the CPU tests
    work: str            # scratch directory of this run (removed at exit)
    spans: "Spans"
    # The control (``portbench/control.py``): when nonzero, the judge puts
    # the reference's chunk lists, cut in independent blocks of this many
    # bytes, in the place of the program's.
    control_block: int = 0


class Spans:
    """The benchmark's own host spans around its calls into the program:
    (label, wall start, wall end), kept in memory for the trace's idle
    gaps."""

    def __init__(self) -> None:
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.items.append((label, t0, time.time()))


class GcClock:
    """Seconds the interpreter's cyclic collector ran, and how many full
    collections it made, from ``gc.callbacks``: printed per iteration on
    standard error, to tell the collector's share of an iteration."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.full = 0
        self._t0 = None
        gc.callbacks.append(self._note)

    def _note(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.full += info["generation"] == 2
            self._t0 = None

    def close(self) -> None:
        gc.callbacks.remove(self._note)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float                  # window start to the last end
    records: list[dict]              # one per iteration of the window
    trace: devtrace.DeviceTrace | None = None
    card: dict | None = None         # sms, sm_hz of the card


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """A module of the benchmark by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_bench(*extra: pathlib.Path) -> dict:
    """BENCHMARK.json, with the lists of each file in ``extra`` appended:
    the entries of a cell that BENCHMARK.json leaves out, which the tests
    still drive (``portbench/tests/data/left_out.json``)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    for path in extra:
        for key, items in load_json(path).items():
            bench[key] = bench[key] + items
    return bench


def banned_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of BANNED_MODULES, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in BANNED_MODULES})


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or
    with ``trace`` its per-layer ones."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        out.append(m)
    return out


def entry_summary(entry, record: dict) -> list[str]:
    """The keys of ``record`` that the entry prints per iteration (its
    ``SUMMARY``), where they hold numbers."""
    keys = getattr(entry, "SUMMARY", ())
    return [k for k in keys if isinstance(record.get(k), (int, float))]


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py",
                                description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_info(torch) -> dict:
    from portbench import peaks
    props = torch.cuda.get_device_properties(0)
    return {"sms": props.multi_processor_count, "sm_hz": peaks.max_sm_hz()}


def main(argv: list[str], t0: float | None = None, device: str | None = None,
         overrides: dict | None = None, control_block: int = 0,
         bench: dict | None = None) -> int:
    """Run one cell once and print its result line. ``device`` None is
    the card, and the run fails without one; the CPU tests pass "cpu"
    and ``overrides`` (config and traffic keys) to drive the rest of a
    run at a small size, and ``bench`` (see ``load_bench``) for a cell
    that BENCHMARK.json leaves out. ``control_block``: see ``Context``."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    bench = load_bench() if bench is None else bench
    wl = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if wl is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(PKG / "cells" / f"{wl['name']}.json")
    for key, value in (overrides or {}).get("config", {}).items():
        config[key] = value
    for key, value in (overrides or {}).get("traffic", {}).items():
        traffic[key] = value

    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            print(f"portbench: the cell needs {wl['chips']} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()} "
                  f"(available: {torch.cuda.is_available()})",
                  file=sys.stderr)
            return 2
        device = "cuda"
    on_card = device == "cuda"

    from makisu_tpu_torch.ops import backend
    summary = backend.backend_ready(device=None if on_card else "cpu")
    if summary is not None:
        print(f"portbench: the device plane did not come up: {summary}",
              file=sys.stderr)
        return 1

    entry_mod = load_module(PKG / "entries" / f"{traffic['entry']}.py")
    work = tempfile.mkdtemp(prefix="portbench-")
    spans = Spans()
    ctx = Context(wl["name"], config, traffic, args.seed, device, work,
                  spans, control_block)
    entry = entry_mod.Entry(ctx)
    try:
        return _run(args, bench, wl, entry, ctx, t0, torch, on_card)
    except Exception:  # noqa: BLE001 - a run that fails prints no result
        traceback.print_exc()
        return 1
    finally:
        entry.close()
        shutil.rmtree(work, ignore_errors=True)


def _run(args, bench, wl, entry, ctx, t0, torch, on_card) -> int:
    entry.setup()
    entry.iterate(-1)  # the untimed warm-up: every shape the window uses
    if on_card:
        torch.cuda.synchronize()
    # Set-up's writes go to disk now, not in the window's first os.sync.
    os.sync()
    setup_s = time.perf_counter() - t0
    card = card_info(torch) if on_card and args.trace else None

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    records: list[dict] = []
    failed = 0
    error = None
    window_wall = time.time()
    start = time.perf_counter()
    deadline = start + args.seconds
    end = start
    gc_clock = GcClock()
    try:
        ctx.spans.items.clear()
        with devtrace.window_marker(prof is not None):
            i = 0
            while time.perf_counter() < deadline:
                w0 = time.time()
                gc0 = (gc_clock.seconds, gc_clock.full, time.process_time())
                try:
                    rec = entry.iterate(i)
                except Exception as e:  # noqa: BLE001 - reported, judged
                    failed += 1
                    error = f"iteration {i}: {type(e).__name__}: {e}"
                    end = time.perf_counter()
                    break
                end = time.perf_counter()
                rec.update(wall_start=w0, wall_end=time.time(),
                           gc_s=gc_clock.seconds - gc0[0],
                           gc_full=gc_clock.full - gc0[1],
                           cpu_s=time.process_time() - gc0[2])
                records.append(rec)
                i += 1
            if on_card:
                torch.cuda.synchronize()
    finally:
        gc_clock.close()
        if prof is not None:
            prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    found = banned_loaded()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 1

    trace = None
    if prof is not None:
        trace = devtrace.reduce(prof, ctx.work, window_wall,
                                entry.host_intervals(records))
        prof = None
    run = Run(ctx.cell, ctx.config, ctx.traffic, setup_s, end - start,
              records, trace, card)
    metrics = {}
    for m in cell_metrics(bench, ctx.cell, bool(args.trace)):
        value = load_module(PKG / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    entry.release()  # the program's state goes before the reference runs
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    compared = entry.judge(records) if records else {}
    t_judge = time.perf_counter() - t_judge
    if error is not None:
        compared["failed_iterations"] = {"value": failed, "limit": 0}
    correct = bool(records) and all(c["value"] <= c["limit"]
                                    for c in compared.values())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu", "count": 1 if on_card else 0,
                   "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(records) + failed,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["compared"] = compared
    if error is not None:
        print(f"portbench: {error}", file=sys.stderr)
    print("portbench: iteration seconds "
          + " ".join(f"{r['wall_end'] - r['wall_start']:.3f}" for r in records)
          + f"; judged in {t_judge:.3f} s", file=sys.stderr)
    for r in records:
        print("portbench: " + " ".join(
            f"{k} {r[k]:.3f}" for k in entry_summary(entry, r))
            + f" gc_s {r['gc_s']:.3f} gc_full {r['gc_full']}"
            + f" cpu_s {r['cpu_s']:.3f}",
            file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
