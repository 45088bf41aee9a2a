"""The port's sharded hash step (``makisu_tpu_torch/parallel/``) against
the reference's (``makisu_tpu/parallel/``), bit for bit.

The port's ranks are processes of one gloo group, started once for the
module by the dry run's runner (``parallel.dryrun.spawn``, a file://
rendezvous under a temp dir, no port), with a ``jax`` on their path
that raises on import: no child imports JAX. They run every mesh
((1, 1), (1, 2), (2, 2), (1, 4), (4, 2)) on the plain versions (CPU
tensors) and keep the gathered results; this process runs the
reference's ``snapshot_hash_step``, ``gear_bitmap_sharded`` and
``sha256_lanes_sharded`` on the conftest's 8-device CPU mesh, and its
``SnapshotHasher.forward``, on the same numpy-seeded inputs.
"""

from __future__ import annotations

import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from makisu_tpu import parallel as ref_parallel
from makisu_tpu.models import SnapshotHasher as RefSnapshotHasher
from makisu_tpu.ops import sha256 as ref_sha256
from makisu_tpu_torch import parallel
from makisu_tpu_torch.ops import gear
from makisu_tpu_torch.parallel import dryrun, pipeline

MESHES = [(1, 1), (1, 2), (2, 2), (1, 4), (4, 2)]
RANKS = 8


def halo_cut_case() -> dict:
    """A (1, 2) mesh case whose first seq boundary has a cut within the
    31 positions whose hash reaches back into the left shard: the cut is
    there with the left neighbour's history and not with the zero-history
    head, so only an applied halo gives it. The first such seed."""
    for seed in range(100_000):
        case = {**dryrun.make_case("tiny", 2, 2, seed=seed),
                "label": "halo_cut-1x2"}
        blocks = torch.from_numpy(dryrun.case_inputs(case)[0])
        half = blocks.shape[1] // 2
        with_history = gear.gear_bitmap(blocks)[0, half // 32]
        cold = gear.gear_bitmap(blocks[:, half:])[0, 0]
        if int(with_history) & 0x7FFFFFFF and int(with_history) != int(cold):
            return case
    raise AssertionError("no seed with a cut at the boundary")


def mesh_cases() -> list[dict]:
    return [dryrun.make_case("tiny", d * s, s, seed=10 + i)
            for i, (d, s) in enumerate(MESHES)] + [halo_cut_case()]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the ranks once; -> (cases, report, out dir)."""
    out = tmp_path_factory.mktemp("ranks")
    poison = tmp_path_factory.mktemp("poison") / "jax"
    poison.mkdir()
    (poison / "__init__.py").write_text(
        "raise ImportError('a rank of the port imported jax')\n")
    cases = mesh_cases()
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = str(poison.parent)
    try:
        rc = dryrun.spawn(RANKS, cases, "cpu", "gloo", str(out),
                          timeout=240, rendezvous_dir=str(out))
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old
    assert rc == 0
    with open(out / "report.json") as f:
        report = json.load(f)
    return cases, report, out


def _reference(case: dict):
    """The reference's sharded step, its two halves and its single-chip
    forward on the case's inputs, on a mesh of the case's shape."""
    world = case["data"] * case["seq"]
    mesh = ref_parallel.make_mesh(jax.devices()[:world],
                                  seq_parallel=case["seq"])
    assert (mesh.shape["data"], mesh.shape["seq"]) == \
        (case["data"], case["seq"])
    blocks, lanes, lengths = dryrun.case_inputs(case)
    b = jax.device_put(blocks, ref_parallel.block_sharding(mesh))
    ln = jax.device_put(lanes, ref_parallel.lane_sharding(mesh))
    lv = jax.device_put(lengths, ref_parallel.lane_vec_sharding(mesh))
    step = ref_parallel.snapshot_hash_step(mesh, case["avg_bits"])(b, ln, lv)
    halves = (ref_parallel.gear_bitmap_sharded(mesh, case["avg_bits"])(b),
              ref_parallel.sha256_lanes_sharded(mesh)(ln, lv))
    model = RefSnapshotHasher(avg_bits=case["avg_bits"],
                              block_bytes=case["block_bytes"],
                              batch=case["batch"], lanes=case["lanes"],
                              lane_cap=case["lane_cap"], use_pallas=False)
    single = model.jit_forward()(blocks, lanes, lengths)
    return [tuple(np.asarray(a) for a in pair)
            for pair in (step, halves, single)]


@pytest.mark.parametrize("index", range(len(MESHES) + 1),
                         ids=[f"{d}x{s}" for d, s in MESHES] + ["halo_cut"])
def test_sharded_step_matches_reference(ranks, index):
    cases, report, out = ranks
    case = cases[index]
    got = np.load(out / f"{case['label']}.npz")
    for want_bitmap, want_digests in _reference(case):
        np.testing.assert_array_equal(got["bitmap"], want_bitmap)
        np.testing.assert_array_equal(got["digests"], want_digests)
    _, lanes, lengths = dryrun.case_inputs(case)
    assert ref_sha256.digest_hex(got["digests"]) == [
        hashlib.sha256(lanes[i, :n].tobytes()).hexdigest()
        for i, n in enumerate(lengths)]
    rec = next(c for c in report["cases"] if c["label"] == case["label"])
    assert not any(rec["mismatches"].values())
    # One record per mesh rank, at the reference's device order; on CPU
    # tensors the wrappers take the plain versions and count no launch.
    assert [r["rank"] for r in rec["ranks"]] == \
        list(range(case["data"] * case["seq"]))
    assert [r["coord"] for r in rec["ranks"]] == [
        [d, s] for d in range(case["data"]) for s in range(case["seq"])]
    assert all(sum(sum(v) for v in r["launches"].values()) == 0
               for r in rec["ranks"])


def test_halo_case_needs_the_neighbours_history(ranks):
    """The halo case's gathered bitmap holds the boundary cut that a
    shard started cold would miss."""
    cases, _, out = ranks
    case = cases[-1]
    blocks = dryrun.case_inputs(case)[0]
    half = blocks.shape[1] // 2
    got = np.load(out / f"{case['label']}.npz")["bitmap"]
    cold = gear.gear_bitmap(torch.from_numpy(blocks[:, half:]))[0, 0]
    assert int(got[0, half // 32]) != int(cold)
    assert int(got[0, half // 32]) & 0x7FFFFFFF


def test_no_rank_left_running(ranks):
    me = str(os.getpid())
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        assert not (ppid == me and b"parallel.dryrun" in cmd), pid


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_rule_matches_reference(n):
    for seq in [None, *[s for s in range(1, n + 1) if n % s == 0]]:
        ref = ref_parallel.make_mesh(jax.devices()[:n], seq_parallel=seq)
        assert parallel.mesh_shape(n, seq) == \
            (ref.shape["data"], ref.shape["seq"])


def test_mesh_shape_rule_refuses_like_reference():
    with pytest.raises(ValueError):
        ref_parallel.make_mesh(jax.devices()[:8], seq_parallel=3)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.mesh_shape(8, 3)


class FakeMesh:
    """What the shard cuts read of a mesh: axis sizes and this rank's
    coordinate."""

    device_type = "cpu"

    def __init__(self, data: int, seq: int, coord) -> None:
        self._sizes, self._coord = (data, seq), coord

    def size(self, dim: int) -> int:
        return self._sizes[dim]

    def get_coordinate(self):
        return self._coord


def test_shard_cuts_follow_the_reference_layout():
    blocks = torch.arange(4 * 256, dtype=torch.int64).reshape(4, 256)
    lanes = torch.arange(16)
    for d in range(2):
        for s in range(2):
            mesh = FakeMesh(2, 2, [d, s])
            assert torch.equal(parallel.block_shard(mesh, blocks),
                               blocks[2 * d:2 * d + 2, 128 * s:128 * s + 128])
            r = 2 * d + s
            assert torch.equal(parallel.lane_shard(mesh, lanes),
                               lanes[4 * r:4 * r + 4])


def test_shape_errors_where_the_reference_refuses():
    mesh = FakeMesh(2, 2, [0, 1])
    with pytest.raises(ValueError, match="batch 3"):
        parallel.block_shard(mesh, torch.zeros(3, 128, dtype=torch.uint8))
    with pytest.raises(ValueError, match="32 \\* seq"):
        parallel.block_shard(mesh, torch.zeros(2, 96, dtype=torch.uint8))
    with pytest.raises(ValueError, match="lanes not divisible"):
        parallel.lane_shard(mesh, torch.zeros(6, 64, dtype=torch.uint8))
    with pytest.raises(ValueError, match="not in the mesh"):
        parallel.block_shard(FakeMesh(2, 2, None),
                             torch.zeros(2, 128, dtype=torch.uint8))
    # A local shard the kernel cannot take fails before any collective.
    with pytest.raises(ValueError, match="multiple of 32"):
        pipeline.gear_bitmap_sharded(mesh)(torch.zeros(1, 48,
                                                       dtype=torch.uint8))


def test_initialize_multihost_without_environment(monkeypatch):
    for var in ("MAKISU_TPU_COORDINATOR", "MAKISU_TPU_NUM_PROCESSES",
                "MAKISU_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_multihost() is False
    assert parallel.initialize_multihost("gloo") is False


def test_dry_run_command_line(tmp_path, capfd):
    assert dryrun.main(["--ranks", "2", "--seq-parallel", "2", "--device",
                        "cpu", "--shapes", "tiny", "--out",
                        str(tmp_path)]) == 0
    assert "dryrun OK [tiny-1x2]: mesh=(data=1, seq=2) on cpu" in \
        capfd.readouterr().out
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["backend"] == "gloo" and report["world"] == 2


def test_a_failed_rank_fails_the_dry_run(tmp_path):
    # 3 lanes over 2 ranks: every rank refuses the cut.
    case = {**dryrun.make_case("tiny", 2), "lanes": 3}
    assert dryrun.spawn(2, [case], "cpu", "gloo", str(tmp_path),
                        timeout=120) == 1
    assert not (tmp_path / "report.json").exists()
