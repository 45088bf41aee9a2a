"""``makisu-tpu explain``: render cache-decision ledgers into answers.

Three questions, one subcommand (input: ``--explain-out`` ledgers from
``utils/ledger.py``, optionally the matching ``--metrics-out`` report):

- **Miss attribution** (``explain LEDGER``): which Dockerfile node
  broke the cache chain, why (reason per consult), which files' changed
  bytes broke it (stat-cache blame), and what the chunk plane did about
  it (dedup ratio, bytes refetched per layer).
- **Build-to-build diff** (``explain LEDGER --baseline OLD``): exactly
  which keys flipped hit→miss between two builds, with the file-level
  blame and the re-chunked byte delta.
- **Warm-rebuild floor profile** (``explain LEDGER --metrics
  report.json``): per-phase wall-time breakdown split into
  *cache-avoidable* (goes away when every consult hits) vs the
  *irreducible floor* (startup + context scan — what the sub-10s
  incremental target has to attack), reusing ``traceexport``'s
  phase/self-time machinery.

All pure functions over loaded dicts — the CLI wiring lives in
``cli.cmd_explain``; tests golden these renderings directly.

Copy of ``makisu_tpu/utils/explain.py``.
"""

from __future__ import annotations

from typing import Any

from makisu_tpu_torch.utils import traceexport
from makisu_tpu_torch.utils.traceexport import fmt_bytes

# Verdicts that mean "the build had to redo work for this key".
MISS_VERDICTS = ("miss", "stale", "error")


def _label(decision: dict) -> str:
    """Human node label for one decision: ``stage 0 step 2 COPY``."""
    parts = []
    if decision.get("stage") is not None:
        parts.append(f"stage {decision['stage']}")
    if decision.get("step") is not None:
        parts.append(f"step {decision['step']}")
    if decision.get("directive"):
        parts.append(str(decision["directive"]))
    return " ".join(parts) if parts else "(no node in scope)"


def _by_source(ledger: dict, source: str) -> list[dict]:
    return [d for d in ledger.get("decisions", [])
            if d.get("source") == source]


def kv_chain(ledger: dict) -> list[dict]:
    """The build's KV consults in build order, one per key (a key
    re-consulted after the prefetch keeps its FIRST verdict — that is
    the decision that shaped the build)."""
    seen: set[str] = set()
    chain: list[dict] = []
    for decision in _by_source(ledger, "kv"):
        key = str(decision.get("key", ""))
        if key in seen:
            continue
        seen.add(key)
        chain.append(decision)
    return chain


def statcache_blame(ledger: dict) -> dict[str, dict]:
    """Stat-cache decisions keyed by the step cache ID they produced —
    the file-level blame for a flipped COPY/ADD key."""
    return {str(d.get("key", "")): d
            for d in _by_source(ledger, "statcache")}


def _verdict_tag(decision: dict) -> str:
    verdict = str(decision.get("verdict", "?"))
    reason = decision.get("reason")
    return f"{verdict} ({reason})" if reason else verdict


# -- miss attribution -------------------------------------------------------


def render_explain(ledger: dict, report: dict | None = None) -> str:
    header = ledger.get("header", {})
    summary = ledger.get("summary", {})
    lines: list[str] = []
    lines.append("makisu-tpu cache explain — command: "
                 f"{header.get('command') or '?'}")
    if header.get("trace_id"):
        lines.append(f"trace id: {header['trace_id']}")
    verdicts = summary.get("verdicts", {})
    lines.append(
        f"decisions: {summary.get('decisions', 0)}  ("
        + "  ".join(f"{v}={n}" for v, n in sorted(verdicts.items()))
        + ")")
    if summary.get("recomputed"):
        lines.append("(summary recomputed: ledger torn before its "
                     "summary line)")

    chain = kv_chain(ledger)
    blame = statcache_blame(ledger)
    lines.append("")
    if chain:
        lines.append("cache chain (KV consults, build order):")
        breaker: dict | None = None
        for decision in chain:
            verdict = decision.get("verdict")
            marker = ""
            if breaker is None and verdict in MISS_VERDICTS:
                breaker = decision
                marker = "  ← broke the cache chain"
            saved = int(decision.get("bytes_saved", 0) or 0)
            extra = f"  saved {fmt_bytes(saved)}" if saved else ""
            lines.append(
                f"  {_label(decision):<24s} {str(decision.get('key', '')):<18s}"
                f" {_verdict_tag(decision)}{extra}{marker}")
        if breaker is not None:
            key = str(breaker.get("key", ""))
            stat = blame.get(key)
            lines.append("")
            if stat and stat.get("changed_files"):
                changed = stat["changed_files"]
                misses = int(stat.get("misses", 0) or 0)
                total = int(stat.get("files", 0) or 0)
                lines.append(
                    f"blame ({_label(breaker)} key {key}): "
                    f"{misses}/{total} context files re-hashed")
                for rel in changed:
                    lines.append(f"    changed: {rel}")
                if misses > len(changed):
                    lines.append(
                        f"    … and {misses - len(changed)} more")
            else:
                lines.append(
                    f"blame ({_label(breaker)} key {key}): no stat-cache"
                    " record — not a COPY/ADD content change (directive"
                    ", args, or an upstream key changed)")
    else:
        lines.append("cache chain: no KV consults recorded")

    indexed = _by_source(ledger, "chunk_index")
    cas = _by_source(ledger, "chunk_cas")
    if indexed or cas:
        lines.append("")
        lines.append("chunk plane (per layer):")
        for decision in indexed:
            total = int(decision.get("bytes_total", 0) or 0)
            added = int(decision.get("bytes_added", 0) or 0)
            ratio = (1.0 - added / total) if total else 0.0
            lines.append(
                f"  indexed {str(decision.get('key', ''))[:16]}  "
                f"{decision.get('added', 0)}/{decision.get('chunks', 0)}"
                f" chunks new — re-chunked {fmt_bytes(added)} of "
                f"{fmt_bytes(total)} (dedup {100.0 * ratio:.1f}%)"
                f"  [{_label(decision)}]")
        for decision in cas:
            refetched = int(decision.get("bytes_refetched", 0) or 0)
            total = int(decision.get("bytes_total", 0) or 0)
            lines.append(
                f"  consult {str(decision.get('key', ''))[:16]}  "
                f"{decision.get('missing', 0)}/"
                f"{decision.get('requested', 0)} chunks missing — "
                f"{_verdict_tag(decision)}, refetched "
                f"{fmt_bytes(refetched)} of {fmt_bytes(total)}")

    lines.append("")
    lines.append(
        f"bytes: saved {fmt_bytes(summary.get('bytes_saved', 0))} from "
        f"cache · refetched {fmt_bytes(summary.get('bytes_refetched', 0))}"
        f" over the wire · re-chunked "
        f"{fmt_bytes(summary.get('bytes_added', 0))} "
        f"(dedup ratio {100.0 * summary.get('dedup_ratio', 0.0):.1f}%)")
    stat = summary.get("statcache", {})
    if stat.get("hits") or stat.get("misses"):
        lines.append(
            f"stat-cache: {stat.get('hits', 0)} hit / "
            f"{stat.get('misses', 0)} re-hashed"
            + (f" (changed: {', '.join(stat['changed_files'][:5])}"
               + ("…" if len(stat.get("changed_files", [])) > 5 else "")
               + ")" if stat.get("changed_files") else ""))

    if report is not None:
        lines.append("")
        lines.append(render_floor_profile(report, summary).rstrip("\n"))
    return "\n".join(lines) + "\n"


# -- build-to-build diff ----------------------------------------------------


def diff_ledgers(current: dict, baseline: dict) -> dict[str, Any]:
    """Structured build-to-build diff of the KV chains, joined by NODE
    POSITION (stage, step) — not raw key, because cache IDs are
    content-addressed: an edit does not flip a key's verdict, it mints
    a NEW key at that step (and chains downstream). A "flip" is
    therefore a node whose baseline consult succeeded and whose current
    one did not; ``key_changed`` marks the content-invalidation case
    (old key hit → new key miss) vs the same-key case (entry evicted /
    KV down)."""
    def by_node(ledger: dict) -> dict:
        return {(str(d.get("stage", "")), d.get("step")): d
                for d in kv_chain(ledger)}

    cur, base = by_node(current), by_node(baseline)
    flipped_miss = []   # hit/empty in baseline -> miss/stale/error now
    flipped_hit = []
    for node, decision in cur.items():
        old = base.get(node)
        if old is None:
            continue
        was_ok = old.get("verdict") not in MISS_VERDICTS
        is_ok = decision.get("verdict") not in MISS_VERDICTS
        entry = {"current": decision, "baseline": old,
                 "key_changed": (str(decision.get("key", ""))
                                 != str(old.get("key", "")))}
        if was_ok and not is_ok:
            flipped_miss.append(entry)
        elif not was_ok and is_ok:
            flipped_hit.append(entry)
    return {
        "flipped_to_miss": flipped_miss,
        "flipped_to_hit": flipped_hit,
        "only_current": [d for n, d in cur.items() if n not in base],
        # Baseline nodes with no current consult: usually the steps
        # BELOW the first break — the prefetch chain stopped before
        # reaching them.
        "only_baseline": [d for n, d in base.items() if n not in cur],
    }


def render_diff(current: dict, baseline: dict) -> str:
    lines: list[str] = []
    lines.append(
        "makisu-tpu cache diff — baseline "
        f"{baseline.get('header', {}).get('trace_id', '?')[:16]} → "
        f"current {current.get('header', {}).get('trace_id', '?')[:16]}")
    diff = diff_ledgers(current, baseline)
    blame = statcache_blame(current)

    lines.append("")
    flipped = diff["flipped_to_miss"]
    lines.append(f"nodes flipped hit→miss ({len(flipped)}):")
    for entry in flipped:
        decision, old = entry["current"], entry["baseline"]
        key, old_key = (str(decision.get("key", "")),
                        str(old.get("key", "")))
        if entry["key_changed"]:
            lines.append(
                f"  {_label(decision):<24s} key {old_key} → {key}  "
                f"(content changed)  {_verdict_tag(decision)}")
        else:
            lines.append(
                f"  {_label(decision):<24s} key {key}  (unchanged key"
                f" — entry lost)  {_verdict_tag(decision)}")
        stat = blame.get(key)
        if stat and stat.get("changed_files"):
            for rel in stat["changed_files"]:
                lines.append(f"      blame: {rel} changed "
                             "(stat-cache re-hash)")
    if not flipped:
        lines.append("  (none)")
    if diff["flipped_to_hit"]:
        lines.append("")
        lines.append(
            f"nodes flipped miss→hit ({len(diff['flipped_to_hit'])}):")
        for entry in diff["flipped_to_hit"]:
            decision = entry["current"]
            lines.append(f"  {_label(decision):<24s} "
                         f"{str(decision.get('key', '')):<18s} "
                         f"{_verdict_tag(decision)}")
    for field, title in (
            ("only_current", "nodes consulted only in current"),
            ("only_baseline",
             "nodes consulted only in baseline (current prefetch "
             "chain stopped above them)")):
        if diff[field]:
            lines.append("")
            lines.append(f"{title} ({len(diff[field])}):")
            for decision in diff[field]:
                lines.append(f"  {_label(decision):<24s} "
                             f"{str(decision.get('key', ''))}")

    cur_sum = current.get("summary", {})
    base_sum = baseline.get("summary", {})
    lines.append("")
    lines.append(
        "re-chunked bytes: baseline "
        f"{fmt_bytes(base_sum.get('bytes_added', 0))} → current "
        f"{fmt_bytes(cur_sum.get('bytes_added', 0))}; wire refetch: "
        f"baseline {fmt_bytes(base_sum.get('bytes_refetched', 0))} → "
        f"current {fmt_bytes(cur_sum.get('bytes_refetched', 0))}")
    return "\n".join(lines) + "\n"


# -- warm-rebuild floor profile ---------------------------------------------

# Floor-profile phases in render order. ``startup`` is everything not
# otherwise classified (process + backend init, config, report
# writing); ``context_scan`` is the BuildPlan construction span
# (stat-walk + re-hash of changed files).
FLOOR_PHASES = ("startup", "context_scan", "pull", "chunk", "hash",
                "push")


def _floor_phase(span_name: str) -> str:
    if span_name == "context_scan":
        return "context_scan"
    phase = traceexport.phase_of(span_name)
    return "startup" if phase == "other" else phase

# Phases a fully-warm cache removes entirely: layer commit (chunk +
# hash), pushes, and cache-driven transfers. Startup and the context
# scan are paid on EVERY build — the irreducible floor the
# always-warm/watch-mode work has to attack.
AVOIDABLE_PHASES = ("pull", "chunk", "hash", "push")


def floor_profile(report: dict,
                  summary: dict | None = None) -> list[dict]:
    """Per-phase self-time rows with the irreducible-vs-cache-avoidable
    split. ``summary`` (a ledger summary) refines the labels: with
    misses recorded, the avoidable time is miss-driven; with a fully
    hit ledger it is residual floor the cache did NOT remove."""
    totals = {phase: 0.0 for phase in FLOOR_PHASES}
    for name, self_t in traceexport.self_time_by_name(report).items():
        totals[_floor_phase(name)] += self_t
    misses = 0
    if summary:
        verdicts = summary.get("verdicts", {})
        misses = sum(int(verdicts.get(v, 0)) for v in MISS_VERDICTS)
    rows = []
    for phase in FLOOR_PHASES:
        avoidable = phase in AVOIDABLE_PHASES
        if avoidable:
            classification = ("cache-avoidable (miss-driven)"
                              if misses else
                              "residual despite full cache hit")
        elif phase == "context_scan":
            classification = ("irreducible floor (stat-walk; re-hash "
                              "part is cache-avoidable)")
        else:
            classification = "irreducible floor (startup)"
        rows.append({"phase": phase, "seconds": totals[phase],
                     "avoidable": avoidable,
                     "class": classification})
    return rows


def render_floor_profile(report: dict,
                         summary: dict | None = None) -> str:
    top = traceexport.root_span(report)
    total = float((top or {}).get("duration") or 0.0)
    rows = floor_profile(report, summary)
    lines = [f"warm-rebuild floor profile (wall {total:.3f}s):"]
    for row in rows:
        pct = 100.0 * row["seconds"] / total if total else 0.0
        lines.append(f"  {row['phase']:<13s} {row['seconds']:8.3f}s "
                     f"{pct:5.1f}%  {row['class']}")
    avoidable = sum(r["seconds"] for r in rows if r["avoidable"])
    floor = sum(r["seconds"] for r in rows if not r["avoidable"])
    lines.append(
        f"  cache-avoidable {avoidable:.3f}s · irreducible floor "
        f"{floor:.3f}s — the floor is what watch-mode/persistent-state"
        " work must attack")
    return "\n".join(lines) + "\n"
