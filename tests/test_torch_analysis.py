"""The port's ``check`` (``makisu_tpu_torch/analysis/``) against the
reference's (``makisu_tpu/analysis/``).

- The reference's fixture triples (``tests/test_analysis.py``): the two
  engines give the same findings, and pragmas and baselines (written by
  either) suppress them alike.
- Rule parity on a tree of 100+ findings: the port's engine over
  ``makisu_tpu/`` with the reference's baseline gives the reference's
  fingerprints and new/suppressed counts.
- The port's self-scan over its own package has no unbaselined finding.
- The command line: the same text and ``makisu-tpu.check.v1`` JSON,
  ``--rule``, the refused filtered update, and no torch import.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
from test_analysis import FIXTURES

from makisu_tpu import analysis as ref_analysis
from makisu_tpu import cli as ref_cli
from makisu_tpu_torch import analysis
from makisu_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scan(engine, tmp_path, source: str | None = None):
    if source is not None:
        (tmp_path / "snippet.py").write_text(textwrap.dedent(source))
    return engine.run_check([str(tmp_path)], engine.default_rules(),
                            root=str(tmp_path))


def as_rows(findings) -> list[tuple]:
    return [(f.rule, f.path, f.line, f.col, f.message, f.snippet)
            for f in findings]


@pytest.mark.parametrize("rule,bad,pragmad", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_findings_match_reference(tmp_path, rule, bad, pragmad):
    ours = scan(analysis, tmp_path, bad)
    assert rule in {f.rule for f in ours}
    assert as_rows(ours) == as_rows(scan(ref_analysis, tmp_path))
    ours = scan(analysis, tmp_path, pragmad)
    assert rule not in {f.rule for f in ours}
    assert as_rows(ours) == as_rows(scan(ref_analysis, tmp_path))


@pytest.mark.parametrize("rule,bad,pragmad", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_baselines_suppress_alike_both_ways(tmp_path, rule, bad, pragmad):
    findings = scan(analysis, tmp_path, bad)
    for writer in (analysis, ref_analysis):
        path = str(tmp_path / f"baseline-{writer.__name__}.json")
        writer.write_baseline(path, scan(writer, tmp_path))
        for reader in (analysis, ref_analysis):
            new, suppressed = reader.apply_baseline(
                scan(reader, tmp_path), reader.load_baseline(path))
            assert new == [] and suppressed == len(findings) > 0


def test_rule_parity_on_the_reference_tree():
    """The port's engine over makisu_tpu/ finds what the reference's
    does, and the reference's baseline splits both alike."""
    tree = [os.path.join(ROOT, "makisu_tpu")]
    ours = analysis.run_check(tree, analysis.default_rules(), root=ROOT)
    theirs = ref_analysis.run_check(tree, ref_analysis.default_rules(),
                                    root=ROOT)
    assert len(theirs) >= 100
    assert [f.fingerprint for f in ours] == [f.fingerprint for f in theirs]
    assert as_rows(ours) == as_rows(theirs)
    path = ref_analysis.default_baseline_path()
    new, suppressed = analysis.apply_baseline(ours,
                                              analysis.load_baseline(path))
    ref_new, ref_suppressed = ref_analysis.apply_baseline(
        theirs, ref_analysis.load_baseline(path))
    assert (as_rows(new), suppressed) == (as_rows(ref_new), ref_suppressed)


def test_port_self_scan_zero_unbaselined():
    findings = analysis.run_check(analysis.default_scan_paths(),
                                  analysis.default_rules(),
                                  root=analysis.repo_root())
    assert {f.path.split("/")[0] for f in findings} <= {"makisu_tpu_torch"}
    new, _ = analysis.apply_baseline(
        findings, analysis.load_baseline(analysis.default_baseline_path()))
    assert new == [], "unbaselined findings:\n" + "\n".join(
        f.render() for f in new)


def test_baseline_schema_is_shared():
    assert analysis.BASELINE_SCHEMA == ref_analysis.BASELINE_SCHEMA
    with open(analysis.default_baseline_path()) as f:
        assert json.load(f)["schema"] == ref_analysis.BASELINE_SCHEMA


BAD = """\
    import json

    def quiet(path, payload):
        try:
            with open(path, "w") as f:
                json.dump(payload, f)
        except Exception:
            pass
    """


def test_cli_round_trip_and_json_match_reference(tmp_path, capsys):
    (tmp_path / "bad.py").write_text(textwrap.dedent(BAD))
    baseline = tmp_path / "baseline.json"
    argv = ["--log-level", "error", "check", str(tmp_path),
            "--baseline", str(baseline)]
    assert cli.main(argv + ["--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert ref_cli.main(argv + ["--json"]) == 1
    assert payload == json.loads(capsys.readouterr().out)
    assert payload["schema"] == "makisu-tpu.check.v1"
    assert {f["rule"] for f in payload["findings"]} == \
        {"atomic-write", "silent-swallow"}
    assert cli.main(argv) == 1
    text = capsys.readouterr().out
    assert ref_cli.main(argv) == 1
    assert text == capsys.readouterr().out
    assert text.endswith("2 new finding(s), 0 baseline-suppressed\n")
    assert cli.main(argv + ["--update-baseline"]) == 0
    assert cli.main(argv + ["--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and payload["suppressed"] == 2
    # The reference's gate reads the port's baseline.
    assert ref_cli.main(argv) == 0


def test_cli_rule_filter(tmp_path, capsys):
    (tmp_path / "bad.py").write_text(textwrap.dedent(BAD))
    argv = ["--log-level", "error", "check", str(tmp_path),
            "--baseline", str(tmp_path / "none.json"), "--json"]
    assert cli.main(argv + ["--rule", "silent-swallow"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in payload["findings"]} == {"silent-swallow"}
    assert payload["rules"] == ["silent-swallow"]
    with pytest.raises(SystemExit, match="unknown rule"):
        cli.main(argv + ["--rule", "not-a-rule"])


def test_cli_refuses_filtered_default_baseline_update(tmp_path):
    with open(analysis.default_baseline_path(), "rb") as f:
        before = f.read()
    for extra in ([str(tmp_path)], ["--rule", "silent-swallow"]):
        with pytest.raises(SystemExit, match="unscanned"):
            cli.main(["--log-level", "error", "check", *extra,
                      "--update-baseline"])
    with open(analysis.default_baseline_path(), "rb") as f:
        assert f.read() == before


def test_check_passes_and_imports_no_torch():
    """``python -m makisu_tpu_torch.cli check`` exits 0 on this tree,
    without importing torch."""
    script = ("import sys\n"
              "from makisu_tpu_torch import cli\n"
              "rc = cli.main(['--log-level', 'error', 'check'])\n"
              "assert 'torch' not in sys.modules, 'torch imported'\n"
              "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "0 new finding(s)" in out.stdout
