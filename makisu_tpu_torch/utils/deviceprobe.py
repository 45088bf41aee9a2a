"""Device-session ledger: one durable record per device-probe attempt.

Copy of ``makisu_tpu/utils/deviceprobe.py`` for the port. The port's
device plane comes up in phases (``ops/backend.py``: driver discovery,
CUDA context creation, device enumeration, the kernels' build and the
first launch), and a hang in any of them never raises. Each attempt's
evidence (how far init got, where it parked, which card it was pointed
at) would live and die with the process; this module keeps it: every
probe attempt (a build's ``backend_ready()``, a worker's warm probe)
appends a ``makisu-tpu.deviceprobe.v1`` line to
``<repo>/build/device_sessions/device_probes.jsonl``.

Record shape (written by ``ops/backend.py``'s watcher thread), the
reference's:

    {"schema": "makisu-tpu.deviceprobe.v1", "ts": ..., "pid": ...,
     "source": "build|worker",
     "platform": "cuda",
     "attachment": {"key": <hashed attachment-env fingerprint>,
                    "vars": [<attachment var NAMES present>]},
     "verdict": "ok|failed|wedged|ok_late|failed_late",
     "detail": "...", "timeout_seconds": N, "total_seconds": N,
     "phase_reached": "<last phase that completed>",
     "wedged_phase": "<phase executing when the budget elapsed>",
     "phases": [{"phase", "seconds", "ok"}, ...],
     "samples": [{"frame", "count", "stack": [...]}, ...]}

The attachment variables are the CUDA ones (``CUDA_VISIBLE_DEVICES``,
``NVIDIA_VISIBLE_DEVICES``, ``CUDA_DEVICE_ORDER``,
``CUDA_MPS_PIPE_DIRECTORY``). ``samples`` is the stack-sample
trajectory: a wedge parks the probe thread inside a C call (context
creation on a card that dropped off the bus) where no exception ever
fires, so the deepest-Python-frame trajectory is the diagnosis.

``doctor --device`` (:func:`render_device_doctor`) reads the whole
ledger and answers the cross-session questions: which phase dominates
the wedges, at which frame, per-attachment verdict history, and when
the route was last healthy. Either package reads the other's ledger and
renders it to the same text.

Path resolution: ``$MAKISU_TPU_DEVICE_SESSIONS_DIR`` wins (empty value
disables recording entirely); unset, the ledger lands in
``<repo>/build/device_sessions``. Recording is additionally gated by
``ops/backend.py`` on the card being the probe's target, so CPU runs
don't write unless the env var opts them in.

Stdlib-only (``doctor --device`` never imports torch), append-only
``O_APPEND`` single-write lines (concurrent processes share the file
safely), and never able to fail a build.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

SCHEMA = "makisu-tpu.deviceprobe.v1"
LEDGER_BASENAME = "device_probes.jsonl"

# Verdicts meaning "the backend never became usable in budget".
_BAD_VERDICTS = ("wedged", "failed", "failed_late")


def sessions_dir() -> str | None:
    """The device-session ledger directory, or None when recording is
    disabled (``MAKISU_TPU_DEVICE_SESSIONS_DIR=""``)."""
    env = os.environ.get("MAKISU_TPU_DEVICE_SESSIONS_DIR")
    if env is not None:
        return env or None
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "build", "device_sessions")


def ledger_path() -> str | None:
    d = sessions_dir()
    return os.path.join(d, LEDGER_BASENAME) if d else None


def append_record(record: dict) -> str | None:
    """Append one record as a single ``O_APPEND`` write (POSIX keeps
    concurrent writers' lines whole — a worker's warm probe and a
    build process can share the file). Returns the path written, or
    None when recording is disabled."""
    path = ledger_path()
    if path is None:
        return None
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    line = json.dumps(record, separators=(",", ":"),
                      default=str) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)
    return path


def read_records(path: str | None = None) -> list[dict]:
    """Load deviceprobe records from a ledger file, a sessions
    directory (every ``*.jsonl`` inside; lines of other schemas are
    skipped), or the
    default directory (``path=None``). Missing paths yield ``[]``;
    torn final lines of a killed process are salvaged like every
    other JSONL artifact."""
    from makisu_tpu_torch.utils import events
    if path is None:
        path = sessions_dir()
    if not path:
        return []
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, name) for name in os.listdir(path)
            if name.endswith(".jsonl"))
    elif os.path.exists(path):
        files = [path]
    else:
        return []
    records: list[dict] = []
    for name in files:
        try:
            lines = events.read_jsonl(name, skip_invalid=True)
        except OSError:
            continue
        records.extend(r for r in lines if r.get("schema") == SCHEMA)
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records


# -- cross-session diagnosis (`makisu-tpu doctor --device`) ----------------


def _fmt_when(ts: float | None) -> str:
    if not ts:
        return "?"
    return time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime(ts))


def _dominant_sample(record: dict) -> dict | None:
    """The longest-held deepest frame of one attempt's trajectory."""
    samples = record.get("samples") or []
    if not samples:
        return None
    return max(samples, key=lambda s: int(s.get("count", 0)))


def render_device_doctor(records: list[dict]) -> str:
    """Human diagnosis across every recorded probe attempt: verdict
    counts, the dominant wedge phase and frame, per-attachment
    history, the last healthy window, and healthy-path phase
    timings."""
    lines: list[str] = []
    n = len(records)
    lines.append(f"makisu-tpu doctor — device route "
                 f"({n} probe attempt{'s' if n != 1 else ''})")
    by_verdict: dict[str, int] = {}
    by_source: dict[str, int] = {}
    for r in records:
        by_verdict[r.get("verdict", "?")] = \
            by_verdict.get(r.get("verdict", "?"), 0) + 1
        by_source[r.get("source", "?")] = \
            by_source.get(r.get("source", "?"), 0) + 1
    lines.append("attempts: " + "  ".join(
        f"{v}×{c}" for v, c in sorted(by_verdict.items()))
        + "   sources: " + " ".join(
        f"{s}×{c}" for s, c in sorted(by_source.items())))

    diagnosis: list[str] = []
    wedged = [r for r in records if r.get("verdict") == "wedged"]
    bad = [r for r in records if r.get("verdict") in _BAD_VERDICTS]
    ok = [r for r in records
          if r.get("verdict") in ("ok", "ok_late")]

    # -- dominant wedge ---------------------------------------------------
    if wedged:
        phases: dict[str, int] = {}
        for r in wedged:
            phase = r.get("wedged_phase") or "?"
            phases[phase] = phases.get(phase, 0) + 1
        phase, count = max(phases.items(), key=lambda kv: kv[1])
        lines.append("")
        lines.append(f"dominant wedge: phase '{phase}' "
                     f"({count} of {len(wedged)} wedged attempts)")
        last = max(wedged, key=lambda r: r.get("ts", 0.0))
        sample = _dominant_sample(last)
        frame = ""
        if sample:
            # "via": the caller above the representative frame — the
            # representative may sit above interpreter parking frames,
            # so locate it in the stack first.
            stack = sample.get("stack") or []
            via = ""
            if sample["frame"] in stack:
                i = stack.index(sample["frame"])
                if i + 1 < len(stack):
                    via = stack[i + 1]
            elif len(stack) > 1:
                via = stack[1]
            frame = sample["frame"] + (f" via {via}" if via else "")
            lines.append(
                f"  deepest frame: {frame} — "
                f"{sample.get('count', 0)} identical samples in the "
                f"last wedge")
        lines.append(
            f"  last wedge: {_fmt_when(last.get('ts'))} after "
            f"{last.get('total_seconds', 0):.0f}s "
            f"(pid {last.get('pid', '?')}, "
            f"source {last.get('source', '?')}, "
            f"reached '{last.get('phase_reached') or 'nothing'}')")
        diagnosis.append(
            f"backend init wedges in '{phase}'"
            + (f" at {frame}" if frame else "")
            + f" — {count}/{len(wedged)} wedged attempts agree")
    failed = [r for r in records
              if r.get("verdict") in ("failed", "failed_late")]
    if failed:
        last = max(failed, key=lambda r: r.get("ts", 0.0))
        lines.append("")
        lines.append(f"init failures: {len(failed)} (last: "
                     f"{_fmt_when(last.get('ts'))} — "
                     f"{last.get('detail', '?')[:120]})")
        if not wedged:
            diagnosis.append(
                f"backend init FAILS (raises) rather than wedging: "
                f"{last.get('detail', '?')[:120]}")

    # -- last healthy window ----------------------------------------------
    lines.append("")
    if ok:
        first_ok = min(ok, key=lambda r: r.get("ts", 0.0))
        last_ok = max(ok, key=lambda r: r.get("ts", 0.0))
        lines.append(
            f"last healthy: {_fmt_when(last_ok.get('ts'))} "
            f"(init {last_ok.get('total_seconds', 0):.1f}s, "
            f"platform {last_ok.get('platform', '?')}); "
            f"{len(ok)} ok attempt{'s' if len(ok) != 1 else ''} "
            f"since {_fmt_when(first_ok.get('ts'))}")
        bad_after = [r for r in bad
                     if r.get("ts", 0.0) > last_ok.get("ts", 0.0)]
        if bad_after:
            diagnosis.append(
                f"{len(bad_after)} failed/wedged attempt(s) SINCE the "
                f"last healthy init — the route regressed, it was not "
                f"always dead")
        # Healthy-path phase timings (p50 per phase across ok runs).
        from makisu_tpu_torch.utils import metrics
        per_phase: dict[str, list[float]] = {}
        for r in ok:
            for p in r.get("phases") or []:
                if p.get("ok"):
                    per_phase.setdefault(p["phase"], []).append(
                        float(p.get("seconds", 0.0)))
        if per_phase:
            lines.append("healthy-path phase p50: " + "  ".join(
                f"{phase}={metrics.percentile(vals, 50):.2f}s"
                for phase, vals in per_phase.items()))
    else:
        lines.append("last healthy: never — no recorded attempt "
                     "reached a usable backend")
        if bad:
            diagnosis.append("no recorded attempt has EVER produced a "
                             "usable backend on this route")

    # -- per-attachment history -------------------------------------------
    by_attach: dict[str, list[dict]] = {}
    for r in records:
        key = (r.get("attachment") or {}).get("key", "?")
        by_attach.setdefault(key, []).append(r)
    if by_attach:
        lines.append("")
        lines.append(f"per-attachment history "
                     f"({len(by_attach)} attachment"
                     f"{'s' if len(by_attach) != 1 else ''}):")
        for key, recs in sorted(by_attach.items()):
            verdicts: dict[str, int] = {}
            for r in recs:
                verdicts[r.get("verdict", "?")] = \
                    verdicts.get(r.get("verdict", "?"), 0) + 1
            last = max(recs, key=lambda r: r.get("ts", 0.0))
            env_vars = (last.get("attachment") or {}).get("vars") or []
            lines.append(
                f"  {key[:12]}…  "
                + " ".join(f"{v}×{c}"
                           for v, c in sorted(verdicts.items()))
                + f"   last {last.get('verdict', '?')} "
                f"{_fmt_when(last.get('ts'))}"
                + (f"   vars: {', '.join(env_vars[:4])}"
                   + ("…" if len(env_vars) > 4 else "")
                   if env_vars else ""))

    lines.append("")
    if diagnosis:
        lines.append("diagnosis: " + "; ".join(diagnosis) + ".")
    else:
        lines.append("diagnosis: device route healthy — every recorded "
                     "attempt reached a usable backend.")
    return "\n".join(lines) + "\n"


def tail(limit: int = 6, path: str | None = None) -> dict[str, Any]:
    """Compact ledger digest for embedding in a report: record count,
    verdict counts, and the last few attempts."""
    records = read_records(path)
    verdicts: dict[str, int] = {}
    for r in records:
        verdicts[r.get("verdict", "?")] = \
            verdicts.get(r.get("verdict", "?"), 0) + 1
    return {
        "records": len(records),
        "verdicts": dict(sorted(verdicts.items())),
        "tail": [{
            "ts": r.get("ts"),
            "source": r.get("source"),
            "verdict": r.get("verdict"),
            "phase": r.get("wedged_phase") or r.get("phase_reached"),
            "total_seconds": r.get("total_seconds"),
        } for r in records[-limit:]],
    }
