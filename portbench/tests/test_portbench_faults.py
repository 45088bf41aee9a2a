"""Whole runs of the harness on the program's plain (``device="cpu"``)
path at a small size, skipping only the look for a card: a sound run
comes out correct, and a run with the timed path broken underneath comes
out not correct, once for each fault a cell can have. The control (the
reference's chunk lists, cut in independent blocks) comes out not
correct too. The cells run on one card, so no exchange between cards
can be left out."""

import json
import pathlib

import pytest

from portbench import harness

# node-app.commit is left out of BENCHMARK.json; its entries are kept here.
BENCH = harness.load_bench(
    pathlib.Path(__file__).resolve().parent / "data" / "left_out.json")

# Cases: a cell and the overrides that shrink it. "cold" drives the build
# entry's cold mode (a fresh storage per build) on the monorepo's files.
CASES = {
    "commit": ("node-app.commit", {"config": {"context_bytes": 96 << 10}}),
    "edit": ("monorepo.edit", {"config": {"context_bytes": 1 << 20}}),
    "cold": ("monorepo.edit", {
        "config": {"context_bytes": 1 << 20},
        "traffic": {"mode": "cold", "expect": {"committed": 4, "hits": 0}}}),
}


@pytest.fixture(autouse=True)
def no_mount_table():
    """Builds in a temp dir under a mount would skip its files."""
    from makisu_tpu_torch.utils import mountinfo
    mountinfo.set_mountpoints_for_testing(set())
    yield
    mountinfo.set_mountpoints_for_testing(None)


def run_case(case: str, capsys, **kw) -> dict | None:
    """The run's result line, or None where it printed none (and exited
    with another code than 0)."""
    cell, overrides = CASES[case]
    rc = harness.main(["--workload", cell, "--seed", "4294967311",
                       "--seconds", "0.1"], device="cpu",
                      overrides=overrides, bench=BENCH, **kw)
    out = capsys.readouterr().out.strip().splitlines()
    if rc != 0:
        assert not out or not out[-1].startswith("{")
        return None
    return json.loads(out[-1])


def not_correct(result) -> bool:
    return result is None or result["correct"] is False


def altered_digest(monkeypatch):
    """A chunk's digest altered where the session produces it."""
    from makisu_tpu_torch.chunker import cdc
    finish = cdc.ChunkSession.finish

    def broken(self):
        chunks = finish(self)
        c = chunks[0]
        chunks[0] = cdc.Chunk(c.offset, c.length,
                              bytes([c.digest[0] ^ 1]) + c.digest[1:])
        return chunks

    monkeypatch.setattr(cdc.ChunkSession, "finish", broken)


def half_left_out(monkeypatch):
    """Half of the session's chunks dropped from its answer."""
    from makisu_tpu_torch.chunker import cdc
    finish = cdc.ChunkSession.finish
    monkeypatch.setattr(cdc.ChunkSession, "finish",
                        lambda self: finish(self)[::2])


def state_unchanged(monkeypatch):
    """Every layer commit after the first answers with the first one's
    identity: a step that returns its state unchanged."""
    from makisu_tpu_torch.chunker import hasher
    finish = hasher.NativeLayerSink.finish
    first = []

    def stale(self):
        commit = finish(self)
        if not first:
            first.append(commit)
        return first[0]

    monkeypatch.setattr(hasher.NativeLayerSink, "finish", stale)


FAULTS = [altered_digest, half_left_out, state_unchanged]


@pytest.mark.parametrize("case", ["commit", "edit", "cold"])
def test_a_sound_run_is_correct(case, capsys):
    result = run_case(case, capsys)
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    e2e = "commit_GBps" if case == "commit" else "build_s"
    assert set(result["metrics"]) == {e2e, "setup_s"}
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("case", ["commit", "cold"])
def test_a_broken_timed_path_is_not_correct(case, fault, capsys,
                                            monkeypatch):
    fault(monkeypatch)
    assert not_correct(run_case(case, capsys))


def test_the_edit_cell_with_a_stale_layer(capsys, monkeypatch):
    state_unchanged(monkeypatch)
    assert not_correct(run_case("edit", capsys))


@pytest.mark.parametrize("case", ["commit", "edit"])
def test_the_control_is_not_correct(case, capsys):
    result = run_case(case, capsys, control_block=16 << 10)
    assert result["correct"] is False
    assert result["compared"]["cut_ends"]["value"] > 0


def test_the_edit_cell_is_judged_after_its_first_manifests_go(
        capsys, monkeypatch):
    """The storage keeps its newest manifests only (16; here 1, so the
    cold build's goes at the warm-up's): the judge reads each build's
    manifest as the build left it."""
    from makisu_tpu_torch.storage import manifests
    evict = manifests.ManifestStore._evict_locked

    def keep_one(self):
        self.max_entries = 1
        evict(self)

    monkeypatch.setattr(manifests.ManifestStore, "_evict_locked", keep_one)
    result = run_case("edit", capsys)
    assert result["correct"] is True, result["compared"]
