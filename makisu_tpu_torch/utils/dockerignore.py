""".dockerignore support (capability beyond the reference, which only
offers --blacklist): the build context's `.dockerignore` filters what
ADD/COPY can see, with docker's semantics — last matching pattern wins,
`!` re-includes, `*`/`?` stay inside one path segment, `**` crosses
segments, a pattern matching a directory excludes everything beneath it
(moby/patternmatcher behavior).

Integration model: patterns are evaluated once per build against a walk
of the context, producing a MINIMAL set of excluded absolute paths
(a fully-excluded directory contributes one entry, not its subtree) that
merges into the existing copy blacklist — the one prefix-exclusion
mechanism both the on-disk Copier and the MemFS copy-op diff already
honor. Negations are exact: a dir with re-included descendants is
descended into and only its excluded children listed.
"""

from __future__ import annotations

import os
import re

IGNORE_FILE = ".dockerignore"


def _translate_segment(seg: str) -> str:
    """One path segment of a pattern → regex (never crosses '/')."""
    out = []
    i = 0
    while i < len(seg):
        c = seg[i]
        if c == "*":
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        elif c == "[":
            j = i + 1
            if j < len(seg) and seg[j] in ("!", "^"):
                j += 1
            if j < len(seg) and seg[j] == "]":
                j += 1
            while j < len(seg) and seg[j] != "]":
                j += 1
            if j < len(seg):  # a real character class
                cls = seg[i + 1:j]
                if cls.startswith("!"):
                    cls = "^" + cls[1:]
                out.append("[" + cls + "]")
                i = j
            else:
                out.append(re.escape(c))
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def _translate(pattern: str) -> re.Pattern:
    segs = pattern.split("/")
    parts: list[str] = []
    for idx, seg in enumerate(segs):
        last = idx == len(segs) - 1
        if seg == "**":
            # "a/**/b": zero or more whole segments; trailing "a/**"
            # matches everything beneath a (but not a itself).
            parts.append(".*" if last else "(?:[^/]+/)*")
        else:
            parts.append(_translate_segment(seg) + ("" if last else "/"))
    return re.compile("".join(parts) + r"\Z")


class PrefixSet:
    """Sorted prefix set with O(log n) descendant lookup — the minimal
    excluded set can be large when negations force per-file entries
    (e.g. 20k-file node_modules with one re-inclusion), and the
    checksum walk probes it once per context path. Entries must be
    prefix-free (no entry beneath another), which excluded_paths'
    collapse guarantees."""

    def __init__(self, paths: list[str]) -> None:
        import bisect
        self._bisect = bisect.bisect_right
        self._sorted = sorted(p.rstrip("/") for p in paths)

    def __bool__(self) -> bool:
        return bool(self._sorted)

    def covers(self, path: str) -> bool:
        """True if path equals or sits beneath any entry."""
        if not self._sorted:
            return False
        path = path.rstrip("/")
        i = self._bisect(self._sorted, path)
        if i and self._sorted[i - 1] == path:
            return True
        # The nearest entry <= path is the only possible ancestor (the
        # set is prefix-free and sorted).
        return bool(i) and path.startswith(self._sorted[i - 1] + "/")


class DockerIgnore:
    """Parsed .dockerignore: ordered (negated, regex) rules."""

    def __init__(self, lines: list[str]) -> None:
        self.rules: list[tuple[bool, re.Pattern]] = []
        self.has_negations = False
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            negated = line.startswith("!")
            if negated:
                line = line[1:].strip()
            # Normalize like docker: patterns are context-root-relative.
            line = line.lstrip("/").rstrip("/")
            line = os.path.normpath(line) if line else ""
            if not line or line == ".":
                continue
            self.rules.append((negated, _translate(line)))
            if negated:
                self.has_negations = True

    @classmethod
    def load(cls, context_dir: str) -> "DockerIgnore | None":
        path = os.path.join(context_dir, IGNORE_FILE)
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                ignore = cls(f.read().splitlines())
        except OSError:
            return None
        return ignore if ignore.rules else None

    def excluded(self, rel: str) -> bool:
        """Docker's algorithm: walk rules in order; a rule matching the
        path OR any ancestor sets the current verdict (last wins)."""
        candidates = [rel]
        parent = os.path.dirname(rel)
        while parent:
            candidates.append(parent)
            parent = os.path.dirname(parent)
        verdict = False
        for negated, rx in self.rules:
            if any(rx.match(c) for c in candidates):
                verdict = not negated
        return verdict

    def excluded_paths(self, context_dir: str) -> list[str]:
        """Walk the context ONCE; return the minimal excluded
        absolute-path set. Without negations an excluded directory is
        pruned whole (nothing beneath can be re-included); with
        negations excluded dirs recurse and collapse back to one entry
        only when every descendant — files, symlinks, and empty dirs
        alike — stayed excluded."""
        return self._walk(context_dir, "")[1]

    def _walk(self, dir_abs: str, dir_rel: str) -> tuple[bool, list[str]]:
        """Returns (all_excluded, minimal_entries) for the contents of
        ``dir_abs``: all_excluded means every entry beneath it is
        excluded (vacuously true for an empty dir); minimal_entries is
        the collapsed excluded set beneath it (never the dir itself)."""
        try:
            names = sorted(os.listdir(dir_abs))
        except OSError:
            return False, []  # unreadable: claim nothing
        all_excluded = True
        entries: list[str] = []
        for name in names:
            abs_path = os.path.join(dir_abs, name)
            rel = os.path.join(dir_rel, name) if dir_rel else name
            is_dir = os.path.isdir(abs_path) and \
                not os.path.islink(abs_path)
            child_excluded = self.excluded(rel)
            if child_excluded and (not is_dir or not self.has_negations):
                entries.append(abs_path)  # whole subtree prunes
                continue
            if not is_dir:
                all_excluded = False
                continue
            sub_all, sub_entries = self._walk(abs_path, rel)
            if child_excluded and sub_all:
                entries.append(abs_path)  # collapse to one entry
            else:
                # Child survives (not excluded, or a descendant was
                # re-included): carry its excluded descendants only.
                all_excluded = False
                entries.extend(sub_entries)
        return all_excluded, entries
