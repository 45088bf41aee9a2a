"""Repo-invariant static analysis (``makisu-tpu-torch check``).

Copy of the reference's ``analysis`` package: the rule engine
(:mod:`engine`) and six rules distilled from shipped bugs
(:mod:`rules`), with per-line ``# check: allow(<rule>)`` pragmas and a
committed ``baseline.json`` so pre-existing findings never block while
new ones fail the gate. It scans this package, against a baseline of
its own. See docs/ANALYSIS.md for the catalog.
"""

from __future__ import annotations

import os

from makisu_tpu_torch.analysis.engine import (BASELINE_SCHEMA, Finding,
                                              FileContext, Rule,
                                              apply_baseline, load_baseline,
                                              run_check, write_baseline)
from makisu_tpu_torch.analysis.rules import ALL_RULES, default_rules

__all__ = [
    "BASELINE_SCHEMA", "Finding", "FileContext", "Rule", "ALL_RULES",
    "apply_baseline", "default_baseline_path", "default_rules",
    "default_scan_paths", "load_baseline", "run_check",
    "write_baseline", "repo_root",
]


def repo_root() -> str:
    """The checkout root (parent of the makisu_tpu_torch package): what
    finding paths and the committed baseline are relative to."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def default_scan_paths() -> list[str]:
    """What ``makisu-tpu-torch check`` scans by default: the port's
    package. Tests and fixtures are left out: they hold intentional
    violations."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")
