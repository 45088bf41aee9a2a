#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printing one JSON line; any failure exits non-zero:

1. build: compile ``makisu_tpu_torch/csrc/*.cu`` with nvcc (in parallel).
2. kernels: the Gear bitmap kernel and the lane SHA-256 kernel against
   their plain PyTorch versions on the card (and SHA-256 against
   hashlib), bit-exact, at the chunker's production shapes; CUDA-event
   timings of kernel and plain version.
3. layer_commit: a ~1 GiB layer tar shaped like a node_modules-heavy
   app (about 50k small text-like files, some large binaries, repeated
   contents) streams through ``GPUHasher().open_layer`` in 16 KiB writes
   at zlib level 6. Tar and gzip digests, chunk tiling, every chunk
   digest (hashlib), the cut positions (plain Gear on the card + the
   whole-stream policy) and the kernels' launch counts are checked. A
   torch.profiler (CUPTI) trace of the commit gives the device time per
   stage and the card's idle share.
4. snapshot_hasher: ``SnapshotHasher.forward`` at its default shape
   against the plain forward on the card.

Then the kernels' summary line, the card's name and power limit as
nvidia-smi reports them, and the final ``{"ok": true, ...}`` line. Needs
one card; exits non-zero without CUDA or outside the repository.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import os
import subprocess
import sys
import tarfile
import time
import traceback

MIB = 1 << 20
LAYER_BYTES = 1024 * MIB
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# Least INT32 work of each function, derived in its kernel's header:
# (ops only the ALU pipe issues, ops the ALU or the FMA pipe issues).
GEAR_OPS_PER_BYTE = (3, 1)
SHA_OPS_PER_BLOCK = (1040, 360)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def int32_ops_per_s(torch) -> float:
    """The ALU pipe's INT32 rate: SMs x 64 lanes x the maximum SM clock
    nvidia-smi reports. The issue limit (4 schedulers x 32 lanes per SM,
    which adds on the FMA pipe can also fill) is twice this."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * mhz * 1e6


def bound(nbytes: float, alu_ops: float, any_ops: float,
          int_rate: float) -> tuple[float, str]:
    """Least milliseconds for the bytes at the memory rate and for the
    ops: ALU-only ops at the ALU rate, all ops at the issue limit."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(alu_ops / int_rate, (alu_ops + any_ops) / (2 * int_rate))
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def time_once_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), result


# -- phase 2: kernels against their plain versions --------------------------

def check_gear(torch, np, dev, int_rate) -> dict:
    from makisu_tpu_torch.ops import backend, gear, gear_cuda

    rng = np.random.default_rng(1)
    words = mismatches = max_err = 0
    for n in (32, 8192, 4 * MIB + 128, 3 * 4 * MIB):
        flat = torch.from_numpy(
            rng.integers(0, 256, size=n, dtype=np.uint8)).to(dev)
        batch = torch.from_numpy(rng.integers(
            0, 256, size=(2, n), dtype=np.uint8)).to(dev)
        for x in (flat, batch):
            for head in gear.HEADS:
                # Small masks set many bits, so they test h's low bits
                # far more densely than the default 13.
                for avg_bits in (gear.DEFAULT_AVG_BITS, 4, 1):
                    got = gear_cuda.gear_bitmap(x, avg_bits, head).cpu()
                    want = gear.gear_bitmap(x, avg_bits, head).cpu()
                    a = got.numpy().astype(np.int64)
                    b = want.numpy().astype(np.int64)
                    words += a.size
                    mismatches += int((a != b).sum())
                    max_err = max(max_err, int(np.abs(a - b).max()))
    check(mismatches == 0, f"gear kernel: {mismatches} of {words} bitmap "
          "words differ from the plain version")
    # Time at the chunker's launch shape: one 4 MiB block + 128-byte halo.
    n = 4 * MIB + 128
    x = torch.from_numpy(rng.integers(0, 256, size=n, dtype=np.uint8)).to(dev)
    ms = backend.time_cuda_ms(lambda: gear_cuda.gear_bitmap(x), reps=50,
                              warmup=3)
    plain_ms = backend.time_cuda_ms(lambda: gear.gear_bitmap(x), reps=5,
                                    warmup=1)
    alu, either = GEAR_OPS_PER_BYTE
    bound_ms, bound_by = bound(n + n / 8, alu * n, either * n, int_rate)
    return {"name": "gear_bitmap", "route": "cuda",
            "source": "makisu_tpu_torch/csrc/gear.cu",
            "replaces": "makisu_tpu/ops/gear_pallas.py:161",
            "also_replaces": "makisu_tpu/ops/gear_pallas.py:283",
            "shape": [n], "words_checked": words, "mismatches": mismatches,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_sha(torch, np, dev, int_rate) -> dict:
    from makisu_tpu_torch.chunker.cdc import _BUCKETS
    from makisu_tpu_torch.ops import backend, sha256, sha256_cuda

    shapes = []
    for cap, lanes in _BUCKETS:
        data, lengths = sha256_cuda.probe_inputs(lanes, cap, seed=7)
        d = torch.from_numpy(data).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        got = sha256_cuda.sha256_lanes(d, ln).cpu().numpy()
        plain_ms, want = time_once_ms(
            torch, lambda: sha256.sha256_lanes(d, ln))
        want = want.cpu().numpy()
        truth = sha256_cuda.hashlib_words(data, lengths)
        mism = int((got != want).any(1).sum())
        mism_hashlib = int((got != truth).any(1).sum())
        check(mism == 0 and mism_hashlib == 0,
              f"sha256 kernel {lanes}x{cap}: {mism} lanes differ from the "
              f"plain version, {mism_hashlib} from hashlib")
        ms = backend.time_cuda_ms(lambda: sha256_cuda.sha256_lanes(d, ln),
                                  reps=10, warmup=2)
        blocks = int(((lengths.astype(np.int64) + 9 + 63) // 64).sum())
        alu, either = SHA_OPS_PER_BLOCK
        bound_ms, bound_by = bound(blocks * 64 + 4 * lanes + 32 * lanes,
                                   alu * blocks, either * blocks, int_rate)
        max_err = int(np.abs(got.astype(np.int64) - want.astype(np.int64))
                      .max())
        shapes.append({"shape": [lanes, cap], "live_blocks": blocks,
                       "mismatches": mism, "hashlib_mismatches": mism_hashlib,
                       "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                       "plain_reps": 1, "bound_ms": bound_ms,
                       "bound_by": bound_by})
    # A length past cap - 9 sets the kernel's error flag.
    sha256_cuda.check_lengths(dev)
    data, lengths = sha256_cuda.probe_inputs(128, 1024, seed=8)
    lengths[3] = 1024 - 8
    sha256_cuda.sha256_lanes(torch.from_numpy(data).to(dev),
                             torch.from_numpy(lengths).to(dev))
    try:
        sha256_cuda.check_lengths(dev)
        flagged = False
    except ValueError:
        flagged = True
    check(flagged, "sha256 kernel did not flag a length past cap - 9")
    main = shapes[0]  # the 16 KiB bucket most chunks take
    return {"name": "sha256_lanes", "route": "cuda",
            "source": "makisu_tpu_torch/csrc/sha256.cu",
            "replaces": "makisu_tpu/ops/sha256_pallas.py:52",
            **{k: main[k] for k in ("shape", "mismatches",
                                    "hashlib_mismatches", "max_abs_err",
                                    "ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            "library_ms": None, "buckets": shapes}


# -- phase 3: a layer commit at real size -------------------------------------

def make_layer_tar(np, target: int, seed: int = 3) -> tuple[bytes, int]:
    """A deterministic layer tar of about ``target`` bytes shaped like a
    node_modules-heavy app: small text-like files (log-uniform 1-64 KiB,
    one in seven repeating an earlier file) until ~75% of the target,
    then random-byte binaries of 4-16 MiB. Returns (tar, file count)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    vocab = [bytes(letters[rng.integers(0, 26, size=int(k))])
             for k in rng.integers(2, 10, size=4000)]
    vocab += [b"function", b"return", b"const", b"require(", b"});\n",
              b"module.exports", b"=>", b"{\n", b"\n"]
    pick = np.minimum(rng.zipf(1.3, size=(8 * MIB) // 5), len(vocab)) - 1
    pool = b" ".join(vocab[i] for i in pick.tolist())
    out = io.BytesIO()
    total = 0
    texts = []  # (pool offset, size) of each text file, for repeats
    nfiles = 0
    with tarfile.open(fileobj=out, mode="w", format=tarfile.PAX_FORMAT) as tf:
        def add(name: str, content: bytes) -> None:
            nonlocal total, nfiles
            info = tarfile.TarInfo(name)
            info.size = len(content)
            info.mode = 0o644
            tf.addfile(info, io.BytesIO(content))
            total += 512 + -(-len(content) // 512) * 512
            nfiles += 1

        k = 0
        while total < 0.75 * target:
            if len(texts) > 8 and rng.random() < 1 / 7:
                at, size = texts[int(rng.integers(0, len(texts)))]
            else:
                size = int(np.exp(rng.uniform(np.log(1024), np.log(65536))))
                at = int(rng.integers(0, len(pool) - size))
                texts.append((at, size))
            add(f"app/node_modules/pkg{k // 40:04d}/lib/f{k:05d}.js",
                pool[at:at + size])
            k += 1
        b = 0
        while total < target:
            size = min(int(rng.integers(4 * MIB, 16 * MIB)),
                       max(target - total, 1))
            add(f"app/bin/blob{b:03d}.bin",
                rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
            b += 1
    return out.getvalue(), nfiles


def plain_cuts(torch, np, tar: bytes, dev) -> np.ndarray:
    """Whole-stream cut ends from the plain Gear version on the card and
    the whole-stream min/max policy (the streaming session's oracle)."""
    from makisu_tpu_torch.ops import gear

    piece = 64 * MIB
    cands = []
    for start in range(0, len(tar), piece):
        lo = max(0, start - 32)  # >= 31 bytes of history before `start`
        seg = np.frombuffer(tar[lo:start + piece], dtype=np.uint8)
        seg = np.concatenate([seg, np.zeros((-len(seg)) % 32, np.uint8)])
        words = gear.gear_bitmap(torch.from_numpy(seg).to(dev)).cpu().numpy()
        live = min(start + piece, len(tar)) - lo
        cands.append(gear.candidates_np(words, start - lo, live) + lo)
    return gear.select_boundaries_np(np.concatenate(cands), len(tar))


STAGES = (("gear", "gear_bitmap_kernel"), ("sha256", "sha256_lanes_kernel"),
          ("h2d", "HtoD"), ("d2h", "DtoH"))


def device_trace(prof, wall_s: float) -> dict:
    """Device time per stage, launches per kernel and the card's idle
    share over ``wall_s`` from a CUDA-activity profiler trace."""
    from makisu_tpu_torch.ops import _build

    path = _build.BUILD_DIR / "layer_commit_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    check(spans, "the profiler trace holds no device activity")
    stage_ms: dict[str, float] = {}
    count: dict[str, int] = {}
    busy_us, reach = 0.0, float("-inf")
    for start, end, name in spans:
        stage = next((st for st, key in STAGES if key in name), "other")
        stage_ms[stage] = stage_ms.get(stage, 0.0) + (end - start) / 1e3
        count[stage] = count.get(stage, 0) + 1
        busy_us += max(0.0, end - max(start, reach))  # union of spans
        reach = max(reach, end)
    busy_ms = busy_us / 1e3
    return {"device_ms": stage_ms, "events": count, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / (wall_s * 1e3),
            "h2d_share": stage_ms.get("h2d", 0.0) / busy_ms}


def layer_commit(torch, np, dev, target: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from makisu_tpu_torch.chunker.hasher import GPUHasher
    from makisu_tpu_torch.ops import backend, gear_cuda, sha256_cuda

    t0 = time.perf_counter()
    tar, nfiles = make_layer_tar(np, target)
    make_s = time.perf_counter() - t0

    out = io.BytesIO()
    backend.reset_dispatch_stats()
    gear_cuda.launches = sha256_cuda.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sink = GPUHasher(device=dev).open_layer(out, backend_id="zlib-6")
        for i in range(0, len(tar), 16 * 1024):
            sink.write(tar[i:i + 16 * 1024])
        commit = sink.finish()
        wall_s = time.perf_counter() - t0
    gear_launches, sha_launches = gear_cuda.launches, sha256_cuda.launches
    session = sink.session
    trace = device_trace(prof, wall_s)

    pair = commit.digest_pair
    check(pair.tar_digest.hex() == hashlib.sha256(tar).hexdigest(),
          "tar digest differs from hashlib")
    blob = out.getvalue()
    check(pair.gzip_descriptor.digest.hex() == hashlib.sha256(blob)
          .hexdigest() and pair.gzip_descriptor.size == len(blob),
          "gzip descriptor differs from the blob")
    check(gzip.decompress(blob) == tar, "gzip blob does not inflate to tar")
    chunks = commit.chunks
    pos = 0
    for c in chunks:
        check(c.offset == pos and c.length > 0, f"chunk gap at {pos}")
        pos += c.length
    check(pos == len(tar), "chunks do not tile the stream")
    mv = memoryview(tar)
    bad = sum(hashlib.sha256(mv[c.offset:c.offset + c.length]).hexdigest()
              != c.hex_digest for c in chunks)
    check(bad == 0, f"{bad} chunk digests differ from hashlib")
    want_ends = plain_cuts(torch, np, tar, dev).tolist()
    check([c.offset + c.length for c in chunks] == want_ends,
          "chunk cuts differ from the plain Gear version + policy")
    check(gear_launches == session.blocks == -(-len(tar) // (4 * MIB)),
          f"gear launches {gear_launches} != 4 MiB blocks {session.blocks}")
    check(sha_launches > 0, "the sha256 kernel never launched")
    check((trace["events"].get("gear"), trace["events"].get("sha256"))
          == (gear_launches, sha_launches),
          f"the trace's kernels {trace['events']} differ from the launch "
          f"counts ({gear_launches}, {sha_launches})")
    distinct = len({c.hex_digest for c in chunks})
    return {"phase": "layer_commit", "bytes": len(tar), "files": nfiles,
            "target_bytes": target, "make_tar_s": make_s,
            "chunks": len(chunks), "distinct_chunks": distinct,
            "dedup_ratio": len(chunks) / max(distinct, 1),
            "gzip_bytes": len(blob), "wall_s": wall_s,
            "compress_s": sink.compress_seconds,
            "session_s": session.host_seconds,
            "session_wait_s": session.wait_seconds,
            "session_gb_per_s": len(tar) / session.host_seconds / 1e9,
            "trace": trace,
            "launches": {"gear_bitmap": gear_launches,
                         "sha256_lanes": sha_launches},
            "buckets": backend.dispatch_stats()}


# -- phase 4: the SnapshotHasher module ----------------------------------------

def snapshot_hasher(torch, np, dev) -> dict:
    from makisu_tpu_torch.models import SnapshotHasher
    from makisu_tpu_torch.ops import gear, gear_cuda, sha256, sha256_cuda

    model = SnapshotHasher(device=dev)
    blocks, lanes, lengths = model.example_inputs(seed=5)
    lengths[:4] = torch.tensor([0, 55, 64, model.lane_cap - 9],
                               dtype=torch.int32)
    gear_cuda.launches = sha256_cuda.launches = 0
    bitmap, digests = model(blocks, lanes, lengths)
    torch.cuda.synchronize()
    sha256_cuda.check_lengths(dev)
    launches = {"gear_bitmap": gear_cuda.launches,
                "sha256_lanes": sha256_cuda.launches}
    want_bitmap = gear.gear_bitmap(blocks, model.avg_bits)
    want_digests = sha256.sha256_lanes(lanes, lengths)
    bm = int((bitmap.cpu().numpy() != want_bitmap.cpu().numpy()).sum())
    dg = int((digests.cpu().numpy() != want_digests.cpu().numpy())
             .any(1).sum())
    check(bm == 0 and dg == 0, f"SnapshotHasher: {bm} bitmap words and "
          f"{dg} digests differ from the plain forward")
    check(launches == {"gear_bitmap": 1, "sha256_lanes": 1},
          f"SnapshotHasher launches {launches}")
    return {"phase": "snapshot_hasher", "blocks": list(blocks.shape),
            "lanes": list(lanes.shape), "bitmap_mismatches": bm,
            "digest_mismatches": dg, "launches": launches}


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np
        import torch

        from makisu_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "root of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one "
              "NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    int_rate = int32_ops_per_s(torch)

    t0 = time.perf_counter()
    built = _build.build_all()
    for name, log in _build.build_logs.items():
        print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "ptxas": {
              n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
              for n, log in _build.build_logs.items()}})

    kernels = [check_gear(torch, np, dev, int_rate),
               check_sha(torch, np, dev, int_rate)]
    emit({"phase": "kernels", "int32_ops_per_s": int_rate,
          "checked": [{k: v for k, v in kr.items() if k != "buckets"}
                      for kr in kernels]})

    commit = layer_commit(torch, np, dev, LAYER_BYTES)
    emit(commit)
    emit(snapshot_hasher(torch, np, dev))

    for kr in kernels:
        kr["launches"] = commit["launches"][kr["name"]]
        check(kr["launches"] > 0, f"{kr['name']} never ran on the main path")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - report any phase failure and exit 1
        traceback.print_exc()
        sys.exit(1)
