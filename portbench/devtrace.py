"""The reduction from a torch.profiler trace to what the per-layer
metrics and the ``breakdown`` read: the card's busy seconds in the
window, the device operations by name (CUPTI names), and the card's idle
gaps labelled by what the host was doing.

The window is marked by one ``record_function`` span; device spans are
the trace's kernels, copies and memsets, clipped to it. Host activity
comes from the benchmark's own spans and the build's log records, in
wall-clock time, aligned to the trace by the window's start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

WINDOW = "portbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each breakdown list


def window_marker(tracing: bool):
    """The span that marks the traced window (nothing when untraced)."""
    if not tracing:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(WINDOW)


@dataclasses.dataclass
class DeviceTrace:
    window_s: float                       # length of the traced window
    busy_s: float                         # union of device spans in it
    ops: dict[str, list]                  # name -> [seconds, count]
    gaps: dict[str, float]                # host label -> idle seconds

    def op_seconds(self, key: str) -> tuple[float, int]:
        """Seconds and count of the device ops whose name holds ``key``."""
        secs = count = 0
        for name, (s, n) in self.ops.items():
            if key in name:
                secs += s
                count += n
        return secs, count

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name, s] for name, (s, _) in ops],
                "idle_gaps": [[label, s] for label, s in gaps]}


def _label_at(wall: float, host: list[tuple[str, float, float]]) -> str:
    """The innermost (shortest) host interval holding ``wall``."""
    best, width = "host, outside every span", float("inf")
    for label, a, b in host:
        if a <= wall <= b and b - a < width:
            best, width = label, b - a
    return best


def reduce_events(events: list[dict], window_wall: float,
                  host: list[tuple[str, float, float]]) -> DeviceTrace:
    """``events``: a chrome trace's ``traceEvents``; ``window_wall``: the
    wall time at which the window's span began; ``host``: (label, wall
    start, wall end) intervals of the host's activity."""
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the profiler trace holds no window span")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    spans = []
    ops: dict[str, list] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        spans.append((a, b))
        entry = ops.setdefault(e["name"], [0.0, 0])
        entry[0] += (b - a) / 1e6
        entry[1] += 1
    spans.sort()
    busy = 0.0
    gaps: dict[str, float] = {}
    reach = w0

    def gap(a: float, b: float) -> None:
        """Share the idle interval [a, b) (trace us) among the host
        intervals over it, each piece to the innermost one."""
        if b <= a:
            return
        lo = window_wall + (a - w0) / 1e6
        hi = window_wall + (b - w0) / 1e6
        cuts = sorted({lo, hi} | {t for _, x, y in host for t in (x, y)
                                  if lo < t < hi})
        for s, e in zip(cuts, cuts[1:]):
            label = _label_at((s + e) / 2, host)
            gaps[label] = gaps.get(label, 0.0) + (e - s)

    for a, b in spans:
        gap(reach, a)
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    gap(reach, w1)
    return DeviceTrace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, ops=ops,
                       gaps=gaps)


def reduce(prof, work: str, window_wall: float,
           host: list[tuple[str, float, float]]) -> DeviceTrace:
    """Export ``prof``'s trace into ``work``, reduce it, delete it."""
    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, window_wall, host)
