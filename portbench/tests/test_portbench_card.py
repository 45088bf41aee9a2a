"""Runs of the harness on the card at a reduced size (64 MiB commits, an
8 MiB monorepo): every cell comes out correct, the traced run reads the device
and its rooflines stay under 100%, and the control comes out not
correct. Marked ``cuda``: they skip without a card.

    python -m pytest portbench/tests -m cuda -q
"""

import json
import pathlib

import pytest

from portbench import harness

# node-app.commit is left out of BENCHMARK.json; its entries are kept here.
BENCH = harness.load_bench(
    pathlib.Path(__file__).resolve().parent / "data" / "left_out.json")

SMALL = {
    "node-app.commit": {"config": {"context_bytes": 64 << 20}},
    "monorepo.edit": {"config": {"context_bytes": 8 << 20}},
}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


def run_cell(cell: str, capsys, trace: int = 0, **kw) -> dict:
    rc = harness.main(["--workload", cell, "--seed", "3000000001",
                       "--seconds", "2", "--trace", str(trace)],
                      overrides=SMALL[cell], bench=BENCH, **kw)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_each_cell_is_correct_on_the_card(card, cell, capsys):
    result = run_cell(cell, capsys)
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1


@pytest.mark.cuda
def test_the_traced_commit_reads_the_device(card, capsys):
    result = run_cell("node-app.commit", capsys, trace=1)
    assert result["correct"] is True
    assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
    for name in ("gear_roofline", "sha256_roofline"):
        assert 0 < result["metrics"][name]["value"] <= 100
    assert result["breakdown"]["device_ops"]


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card(card, capsys):
    result = run_cell("node-app.commit", capsys, control_block=4 << 20)
    assert result["correct"] is False
    assert result["compared"]["cut_ends"]["value"] > 0
