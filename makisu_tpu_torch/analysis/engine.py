"""Rule engine for ``makisu-tpu-torch check``: repo-invariant static
analysis.

Copy of ``makisu_tpu/analysis/engine.py``, stdlib-only as it is, with
the same baseline schema, fingerprints and finding format, so either
package's gate reads the other's ``baseline.json``. Review rounds of the
reference caught the same invariant classes by hand again and again:
contextvars must ride into thread pools, signal-context code must never
block on a lock, durable state must be written atomically, metric names
must come from the ``utils/metrics.py`` registry. This engine
mechanizes those reviews:

- :class:`Rule` — an AST-visitor rule. ``collect(ctx)`` runs once per
  file and may return findings immediately; whole-program rules (the
  signal-safety call graph) accumulate in ``collect`` and emit from
  ``finalize()`` once every file has been seen.
- Pragmas: ``# check: allow(<rule>[, <rule>...])`` on the finding line
  or the line directly above suppresses that rule there — the reviewed,
  in-source equivalent of a lint ignore, greppable by rule name.
- Baseline: a committed JSON file of pre-existing findings so the gate
  fails only on NEW violations. Findings are keyed by
  ``(rule, path, stripped source line)`` with a count — stable across
  unrelated edits that shift line numbers, invalidated exactly when
  the flagged line itself changes (which IS a new finding to review).

The engine imports nothing from the build tree (and not torch), so
``check`` runs before anything else is importable.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Any, Iterable

BASELINE_SCHEMA = "makisu-tpu.analysis-baseline.v1"

_PRAGMA_RE = re.compile(r"#\s*check:\s*allow\(([^)]*)\)")


class Finding:
    """One rule violation at a source location."""

    __slots__ = ("rule", "path", "line", "col", "message", "snippet")

    def __init__(self, rule: str, path: str, line: int, col: int,
                 message: str, snippet: str) -> None:
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.message = message
        self.snippet = snippet

    @property
    def fingerprint(self) -> tuple[str, str, str]:
        # Line numbers deliberately excluded: the baseline must survive
        # unrelated edits above the flagged line. The stripped line text
        # pins the finding to its code — edit the line, and it is a new
        # finding again.
        return (self.rule, self.path, self.snippet)

    def to_dict(self) -> dict[str, Any]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: [{self.rule}] "
                f"{self.message}\n    {self.snippet}")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Finding({self.rule}, {self.path}:{self.line})"


class FileContext:
    """One parsed source file handed to every rule's ``collect``."""

    def __init__(self, path: str, abspath: str, source: str,
                 tree: ast.AST) -> None:
        self.path = path          # repo-relative, forward slashes
        self.abspath = abspath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._allows: dict[int, set[str]] = {}
        for lineno, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                self._allows[lineno] = rules

    def allowed(self, rule: str, lineno: int) -> bool:
        """Pragma check: the finding line itself or the line above."""
        for at in (lineno, lineno - 1):
            rules = self._allows.get(at)
            if rules and (rule in rules or "*" in rules):
                return True
        return False

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule, self.path, line, col, message,
                       self.line_text(line))


class Rule:
    """Base rule. Subclasses set ``name``/``description`` and override
    ``collect`` (and ``finalize`` for whole-program rules)."""

    name = "rule"
    description = ""

    def collect(self, ctx: FileContext) -> list[Finding]:
        raise NotImplementedError

    def finalize(self) -> list[Finding]:
        return []


def call_name(node: ast.Call) -> str:
    """Dotted name of a call's callee, best effort: ``threading.Thread``,
    ``metrics.counter_add``, ``x.y.submit``; "" for computed callees."""
    parts: list[str] = []
    cur: ast.AST = node.func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif parts:
        # Receiver is an expression (a call, a subscript): keep the
        # attribute path, mark the base as opaque.
        parts.append("<expr>")
    else:
        return ""
    return ".".join(reversed(parts))


def last_attr(node: ast.Call) -> str:
    """The final attribute/name of a call's callee (``submit`` for
    ``a.b.submit(...)``)."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return ""


def keyword_arg(node: ast.Call, name: str) -> ast.expr | None:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def expr_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    # Degrading to "" is the contract: rules treat an unrenderable
    # expression as unmatchable.  # check: allow(silent-swallow)
    except Exception:  # pragma: no cover - malformed synthetic nodes
        return ""


# -- file discovery ---------------------------------------------------------


_SKIP_DIRS = {"__pycache__", ".git", ".hypothesis", "node_modules"}


def iter_py_files(paths: Iterable[str]) -> list[str]:
    out: list[str] = []
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                out.append(os.path.abspath(path))
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.abspath(
                        os.path.join(dirpath, fn)))
    return sorted(set(out))


def run_check(paths: Iterable[str], rules: Iterable[Rule],
              root: str | None = None) -> list[Finding]:
    """Run every rule over every ``.py`` file under ``paths``. Finding
    paths are rendered relative to ``root`` (default: the common parent
    of the scanned paths) so baselines are repo-relocatable."""
    rules = list(rules)
    paths = list(paths)
    missing = [p for p in paths if not os.path.exists(p)]
    files = iter_py_files(p for p in paths if os.path.exists(p))
    if root is None:
        root = (os.path.commonpath([os.path.dirname(f) for f in files])
                if files else os.getcwd())
    root = os.path.abspath(root)
    findings: list[Finding] = []
    for path in missing:
        # A typo'd path must fail the gate, not scan zero files and
        # report a clean pass forever.
        findings.append(Finding(
            "parse-error", _relpath(os.path.abspath(path), root), 1, 0,
            "scan path does not exist", ""))
    for path in paths:
        # Same fail-loud contract for an explicit file argument that
        # exists but is not Python: silently scanning nothing looks
        # identical to a clean pass.
        if os.path.isfile(path) and not path.endswith(".py"):
            findings.append(Finding(
                "parse-error", _relpath(os.path.abspath(path), root),
                1, 0, "explicit scan path is not a .py file", ""))
    for abspath in files:
        try:
            with open(abspath, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=abspath)
        except (OSError, SyntaxError, ValueError) as e:
            rel = _relpath(abspath, root)
            findings.append(Finding(
                "parse-error", rel, 1, 0,
                f"file could not be analyzed: {e}", ""))
            continue
        ctx = FileContext(_relpath(abspath, root), abspath, source, tree)
        for rule in rules:
            for finding in rule.collect(ctx):
                if not ctx.allowed(finding.rule, finding.line):
                    findings.append(finding)
    # Whole-program rules emit after the full tree has been seen; their
    # findings carry their own FileContext pragma decision (the engine
    # cannot re-check here without re-reading files, so finalize-phase
    # rules filter pragmas themselves via the contexts they retained).
    for rule in rules:
        findings.extend(rule.finalize())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _relpath(abspath: str, root: str) -> str:
    try:
        rel = os.path.relpath(abspath, root)
    except ValueError:  # pragma: no cover - cross-drive (windows)
        rel = abspath
    if rel.startswith(".."):
        rel = abspath
    return rel.replace(os.sep, "/")


# -- baseline ---------------------------------------------------------------


def load_baseline(path: str) -> dict[tuple[str, str, str], int]:
    """Baseline file → fingerprint → allowed count. Missing file is an
    empty baseline (everything surfaces)."""
    try:
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
    except OSError:
        return {}
    if raw.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"{path}: not an analysis baseline "
            f"(schema {raw.get('schema')!r}, want {BASELINE_SCHEMA!r})")
    out: dict[tuple[str, str, str], int] = {}
    for entry in raw.get("findings", []):
        key = (entry["rule"], entry["path"], entry["snippet"])
        out[key] = out.get(key, 0) + int(entry.get("count", 1))
    return out


def apply_baseline(findings: list[Finding],
                   baseline: dict[tuple[str, str, str], int]
                   ) -> tuple[list[Finding], int]:
    """Split findings into (new, suppressed_count). The first N
    occurrences of a baselined fingerprint are suppressed; occurrences
    beyond the recorded count surface as new."""
    remaining = dict(baseline)
    new: list[Finding] = []
    suppressed = 0
    for f in findings:
        left = remaining.get(f.fingerprint, 0)
        if left > 0:
            remaining[f.fingerprint] = left - 1
            suppressed += 1
        else:
            new.append(f)
    return new, suppressed


def write_baseline(path: str, findings: list[Finding]) -> None:
    """Serialize ALL current findings as the new baseline (sorted and
    count-folded for stable diffs). Written atomically the same way the
    telemetry reports are — a killed `--update-baseline` must not leave
    a torn gate file."""
    counts: dict[tuple[str, str, str], int] = {}
    for f in findings:
        counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
    payload = {
        "schema": BASELINE_SCHEMA,
        "comment": "Pre-existing `makisu-tpu-torch check` findings, "
                   "keyed by (rule, path, source line). New findings "
                   "fail the gate; regenerate with "
                   "`makisu-tpu-torch check --update-baseline` and "
                   "review the diff.",
        "findings": [
            {"rule": rule, "path": fpath, "snippet": snippet,
             "count": count}
            for (rule, fpath, snippet), count in sorted(counts.items())
        ],
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            # This IS an atomic write (unique temp + os.replace);
            # fileio would be a circular import from the one module
            # that must import nothing from the build tree.
            # check: allow(atomic-write)
            json.dump(payload, f, indent=1, sort_keys=False)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
