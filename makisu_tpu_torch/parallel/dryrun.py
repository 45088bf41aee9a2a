"""Multi-rank dry run of the sharded hash step.

    python -m makisu_tpu_torch.parallel.dryrun --ranks N
        [--seq-parallel S ...] [--device cuda|cpu] [--backend nccl|gloo]
        [--shapes tiny,production] [--out DIR]

The port's counterpart of the reference's ``dryrun_multichip``: it
starts N rank processes in one ``torch.distributed`` group, builds a
(data, seq) mesh over them for each ``--seq-parallel`` (default: the
mesh rule of ``parallel/mesh.py``), runs ``SnapshotHasher.sharded_step``
on each shape, gathers the shards and requires bit-equality with the
single-device ``SnapshotHasher.forward``, the plain versions (on the
card: the plain PyTorch functions on the same tensors) and hashlib.
Rank 0 prints one line per mesh and shape; ``--out DIR`` keeps
``report.json`` (every rank's launches and step times) and each case's
gathered results (``<label>.npz``). Any failed rank fails the run: the
others are killed and it exits 1; no rank process outlives it.

Shapes (the reference's two, and the model's default lanes):
- ``tiny``: ``32 * 8 * seq``-byte blocks, ``2 * world`` lanes of 128;
- ``production``: 4 MiB blocks (the chunker's), ``2 * world`` lanes of
  2,048;
- ``hasher_default``: ``SnapshotHasher``'s defaults, 1 MiB blocks and
  1,024 lanes of 16 KiB.
Every shape has one block row per data index.

Ranks sharing one card must use ``--backend gloo`` (NCCL refuses two
ranks on one device); ``nccl`` needs a card per rank. The choice is the
caller's: nothing retries on the other.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from makisu_tpu_torch.utils import fileio

MIB = 1 << 20
SHAPES = ("tiny", "production", "hasher_default")
# How long a rank waits in a collective for a peer (a failed rank's
# peers are killed by the parent long before).
COLLECTIVE_TIMEOUT_S = 600


def make_case(shape: str, world: int, seq_parallel: int | None = None,
              seed: int = 0) -> dict:
    """One dry-run case: a mesh of ``world`` ranks and a shape."""
    from makisu_tpu_torch.ops import gear
    from makisu_tpu_torch.parallel.mesh import mesh_shape

    data, seq = mesh_shape(world, seq_parallel)
    if shape == "tiny":
        block_bytes, lanes, cap = 32 * 8 * seq, 2 * world, 128
    elif shape == "production":
        block_bytes, lanes, cap = 4 * MIB, 2 * world, 2048
    elif shape == "hasher_default":
        block_bytes, lanes, cap = 1 * MIB, 1024, 16 * 1024
    else:
        raise ValueError(f"unknown shape {shape!r} (one of {SHAPES})")
    return {"label": f"{shape}-{data}x{seq}", "shape": shape,
            "data": data, "seq": seq, "batch": data,
            "block_bytes": block_bytes, "lanes": lanes, "lane_cap": cap,
            "avg_bits": gear.DEFAULT_AVG_BITS, "seed": seed}


def case_inputs(case: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The case's seeded (blocks, lanes, lengths): uint8 [batch,
    block_bytes], uint8 [lanes, lane_cap], int32 lengths in [0, lane_cap
    - 10] (the reference dry run's draw)."""
    rng = np.random.default_rng(case["seed"])
    blocks = rng.integers(0, 256, size=(case["batch"], case["block_bytes"]),
                          dtype=np.uint8)
    lanes = rng.integers(0, 256, size=(case["lanes"], case["lane_cap"]),
                         dtype=np.uint8)
    lengths = rng.integers(0, case["lane_cap"] - 9,
                           size=case["lanes"]).astype(np.int32)
    return blocks, lanes, lengths


def rank_device(device: str) -> torch.device:
    """This rank's device: the CPU, or card ``rank % cards`` (every rank
    on one card shares it)."""
    from makisu_tpu_torch.ops import backend

    dev = backend.resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _timed_step(step, args, dev: torch.device) -> tuple[float, tuple]:
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = step(*args)
        return (time.perf_counter() - t0) * 1e3, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = step(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _mismatches(got: torch.Tensor, want) -> int:
    """Rows of ``got`` that differ from ``want`` (a tensor or array)."""
    a = got.cpu().numpy()
    b = want.cpu().numpy() if isinstance(want, torch.Tensor) else want
    if a.shape != b.shape:
        raise RuntimeError(f"shape {a.shape} against {b.shape}")
    return int((a.reshape(len(a), -1) != b.reshape(len(b), -1))
               .any(1).sum())


def run_case(case: dict, dev: torch.device, out_dir: str | None) -> dict:
    """One case on every rank of the default group (ranks outside its
    mesh only join the collectives). Returns the case's record on rank
    0, with every rank's; raises on a mismatch or a wrong launch count."""
    from makisu_tpu_torch.models import SnapshotHasher
    from makisu_tpu_torch.ops import gear, gear_cuda, sha256, sha256_cuda
    from makisu_tpu_torch.parallel import mesh as mesh_mod

    t0 = time.perf_counter()
    mesh = mesh_mod.make_mesh(case["data"] * case["seq"], case["seq"])
    inputs = case_inputs(case)
    blocks, lanes, lengths = (torch.from_numpy(a) for a in inputs)
    mine = None
    if mesh.get_coordinate() is not None:
        d, s = mesh_mod.coordinate(mesh)
        args = (mesh_mod.block_shard(mesh, blocks).to(dev),
                mesh_mod.lane_shard(mesh, lanes).to(dev),
                mesh_mod.lane_shard(mesh, lengths).to(dev))
        model = SnapshotHasher(case["avg_bits"], case["block_bytes"],
                               case["batch"], case["lanes"],
                               case["lane_cap"], device=dev)
        step = model.sharded_step(mesh)
        mine = {"rank": dist.get_rank(), "coord": [d, s],
                "device": str(dev), "step_ms": [],
                "timer": "cuda_events" if dev.type == "cuda"
                else "host_clock",
                "launches": {"gear_bitmap": [], "gear_bitmap_halo": [],
                             "sha256_lanes": []}}
        # Twice: the first step pays the libraries' load and the
        # groups' first use; the second is the steady step.
        for _ in range(2):
            before = (gear_cuda.launches, gear_cuda.halo_launches,
                      sha256_cuda.launches)
            ms, (bitmap, digests) = _timed_step(step, args, dev)
            mine["step_ms"].append(ms)
            for key, was, now in zip(
                    ("gear_bitmap", "gear_bitmap_halo", "sha256_lanes"),
                    before, (gear_cuda.launches, gear_cuda.halo_launches,
                             sha256_cuda.launches)):
                mine["launches"][key].append(now - was)
        if dev.type == "cuda":
            want = {"gear_bitmap": [1, 1], "sha256_lanes": [1, 1],
                    "gear_bitmap_halo": [int(s > 0)] * 2}
            if mine["launches"] != want:
                raise RuntimeError(f"rank {dist.get_rank()} at ({d}, {s}):"
                                   f" launches per step {mine['launches']},"
                                   f" want {want}")
        full_bitmap = mesh_mod.gather_blocks(mesh, bitmap)
        full_digests = mesh_mod.gather_lanes(mesh, digests)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if dist.get_rank() != 0:
        return {}
    t_check = time.perf_counter()
    lanes_np, lengths_np = inputs[1:]
    blocks, lanes, lengths = (t.to(dev) for t in (blocks, lanes, lengths))
    single_bitmap, single_digests = model(blocks, lanes, lengths)
    sha256_cuda.check_lengths(dev)
    mism = {"single_bitmap_rows": _mismatches(full_bitmap, single_bitmap),
            "single_digests": _mismatches(full_digests, single_digests),
            "hashlib_digests": _mismatches(
                full_digests, sha256_cuda.hashlib_words(lanes_np,
                                                        lengths_np))}
    if dev.type == "cuda":
        # The plain versions on the same tensors (on the CPU the
        # single-device forward is the plain version).
        mism["plain_bitmap_rows"] = _mismatches(
            full_bitmap, gear.gear_bitmap(blocks, case["avg_bits"]))
        mism["plain_digests"] = _mismatches(
            full_digests, sha256.sha256_lanes(lanes, lengths))
    if any(mism.values()):
        raise RuntimeError(f"{case['label']}: the gathered results differ: "
                           f"{mism}")
    if out_dir:
        np.savez(os.path.join(out_dir, f"{case['label']}.npz"),
                 bitmap=full_bitmap.cpu().numpy(),
                 digests=full_digests.cpu().numpy())
    members = [r for r in ranks if r is not None]
    halo = sum(r["coord"][1] > 0 for r in members)
    per_shard = case["block_bytes"] // case["seq"]
    print(f"dryrun OK [{case['label']}]: mesh=(data={case['data']}, "
          f"seq={case['seq']}) on {dev.type}, block_bytes="
          f"{case['block_bytes']} (per-shard {per_shard}, {halo} of "
          f"{len(members)} shards from a halo), bitmap "
          f"{tuple(full_bitmap.shape)}, digests "
          f"{tuple(full_digests.shape)}, steady step ms "
          f"{[round(r['step_ms'][-1], 3) for r in members]}", flush=True)
    return {**case, "mismatches": mism, "ranks": members,
            "seconds": time.perf_counter() - t0,
            "check_s": time.perf_counter() - t_check}


def run_cases(cases: list[dict], device: str,
              out_dir: str | None = None) -> list[dict]:
    """Every case on this rank of the initialised default group; rank 0
    returns the cases' records (and writes ``report.json`` to
    ``out_dir``), the others empty records."""
    dev = rank_device(device)
    records = [run_case(case, dev, out_dir) for case in cases]
    if out_dir and dist.get_rank() == 0:
        fileio.write_json_atomic(
            os.path.join(out_dir, "report.json"),
            {"device": str(dev), "backend": dist.get_backend(),
             "world": dist.get_world_size(), "cases": records})
    return records


def rank_main(args) -> int:
    dist.init_process_group(
        args.backend, init_method=args.init_method, world_size=args.ranks,
        rank=args.rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        run_cases(json.loads(args.cases), args.device, args.out or None)
    finally:
        dist.destroy_process_group()
    return 0


def spawn(ranks: int, cases: list[dict], device: str, backend: str,
          out_dir: str | None = None, timeout: float = 900.0,
          rendezvous_dir: str | None = None) -> int:
    """Run ``cases`` on ``ranks`` processes of this module; their exit
    codes' verdict (0: every rank passed). A rank that fails or outlives
    ``timeout`` gets the others killed; none is left running. The group
    meets at a file:// rendezvous in a fresh directory (under
    ``rendezvous_dir`` if given)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p)}
    with tempfile.TemporaryDirectory(prefix="makisu-dryrun-",
                                     dir=rendezvous_dir) as tmp:
        argv = [sys.executable, "-m", "makisu_tpu_torch.parallel.dryrun",
                "--ranks", str(ranks), "--device", device, "--backend",
                backend, "--init-method", f"file://{tmp}/rendezvous",
                "--cases", json.dumps(cases), "--out", out_dir or ""]
        procs = [subprocess.Popen([*argv, "--rank", str(r)], env=env)
                 for r in range(ranks)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            codes = [p.wait() for p in procs]
    if any(codes):
        print(f"dryrun: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m makisu_tpu_torch.parallel.dryrun",
        description="Run the sharded hash step on N rank processes and "
                    "hold it bit for bit against the single-device step, "
                    "the plain versions and hashlib.")
    parser.add_argument("--ranks", type=int, required=True,
                        help="processes in the group (the mesh's devices)")
    parser.add_argument("--seq-parallel", type=int, action="append",
                        default=[], metavar="S",
                        help="the seq axis of a mesh to run (repeatable; "
                             "default: the mesh rule's)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        help="default: nccl on cuda, gloo on cpu")
    parser.add_argument("--shapes", default="tiny,production",
                        help=f"comma-separated, of {', '.join(SHAPES)}")
    parser.add_argument("--out", default="",
                        help="directory for report.json and each case's "
                             "gathered results")
    # A rank process of a spawned run (spawn passes these).
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--init-method", help=argparse.SUPPRESS)
    parser.add_argument("--cases", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    args.backend = args.backend or ("nccl" if args.device == "cuda"
                                    else "gloo")
    if args.rank is not None:
        return rank_main(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: CUDA is not available; pass --device cpu",
              file=sys.stderr)
        return 2
    cases = [make_case(shape, args.ranks, seq)
             for seq in (args.seq_parallel or [None])
             for shape in args.shapes.split(",")]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    return spawn(args.ranks, cases, args.device, args.backend,
                 args.out or None)


if __name__ == "__main__":
    sys.exit(main())
