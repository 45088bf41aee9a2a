"""The benchmark's boundaries: no module of it imports JAX or the JAX
package; the reference imports nothing of the program; BENCHMARK.json
keeps to its contract and every name in it has its file."""

import ast
import json
import pathlib
import re

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1]
ROOT = PKG.parent
BANNED = {"jax", "jaxlib", "flax", "makisu_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imported_top_levels(path: pathlib.Path) -> set[str]:
    """Top-level module names (before the first dot) a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): imported_top_levels(p) & BANNED
             for p in PKG.rglob("*.py")}
    assert {k: v for k, v in found.items() if v} == {}


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".", 1)[0]
                assert top != "makisu_tpu_torch", (path, mod)
                assert top not in BANNED, (path, mod)
                if top == "portbench":
                    assert mod.startswith("portbench.reference"), (path, mod)


def test_respdouble_imports_no_torch():
    assert "torch" not in imported_top_levels(PKG / "respdouble.py")


@pytest.mark.parametrize("left_out", [False, True])
def test_benchmark_json_keeps_to_its_contract(left_out):
    """BENCHMARK.json, and BENCHMARK.json with the entries of the cell it
    leaves out put back."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if left_out:
        extra = json.loads((PKG / "tests" / "data" / "left_out.json")
                           .read_text())
        for key, items in extra.items():
            bench[key] = bench[key] + items
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert 1 <= len(c["why"]) <= 200
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = json.loads((PKG / "cells" / f"{w['name']}.json").read_text())
        assert (PKG / "entries" / f"{cell['entry']}.py").exists()
        cells.add(w["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert 1 <= len(m["layer"]) <= 200
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (PKG / "metrics" / f"{m['name']}.py").exists()
    for cell in cells:
        reports = [m for m in metrics
                   if cell in m.get("workloads", cells)]
        assert any(m["name"] == "setup_s" for m in reports)
        assert any(m["name"] in e2e and m["name"] != "setup_s"
                   for m in reports)
        assert any(m["name"] not in e2e for m in reports)
    assert len(json.dumps(bench)) < 64 * 1024
