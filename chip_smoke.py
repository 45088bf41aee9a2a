#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printing one JSON line; any failure exits non-zero:

1. build: compile ``makisu_tpu_torch/csrc/*.cu`` with nvcc (in parallel);
   fails if ptxas reports a spill.
2. layer: make a ~1 GiB layer tar shaped like a node_modules-heavy app
   (about 50k small text-like files, some large binaries, repeated
   contents) and its whole-stream cut oracle (plain Gear on the card +
   the whole-stream min/max policy).
3. layer_commit: the layer streams through ``GPUHasher().open_layer`` in
   16 KiB writes at zlib level 6. Tar and gzip digests, chunk tiling,
   every chunk digest (hashlib), the cut positions (the oracle), the
   kernels' launch counts and the session's H2D bytes are checked. A
   torch.profiler (CUPTI) trace of the commit gives the device time per
   stage and the card's idle share.
4. kernels: the Gear bitmap kernel and the span SHA-256 kernel against
   their plain PyTorch versions on the card (and SHA-256 against
   hashlib), bit-exact, at the chunker's production shapes: G1 on one
   4 MiB block + halo, S1 on the chunks of one pass over the session's
   ring (sorted longest first), plus the two lane shapes of the first
   port slice. Kernel times are CUPTI durations from the commit's trace
   (G1's median launch; S1's first launch, which hashes the same spans),
   with event pairs queued behind a spin kernel beside them.
5. snapshot_hasher: ``SnapshotHasher.forward`` at its default shape
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
import re
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
SHA_SLOTS_PER_BLOCK = sum(SHA_OPS_PER_BLOCK)  # one warp: 1 instruction/clock
SPAN_META_BYTES = 8   # int32 ring offset + int32 length per span
DIGEST_BYTES = 32


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


def max_sm_hz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def int32_ops_per_s(torch) -> float:
    """The ALU pipe's INT32 rate: SMs x 64 lanes x the maximum SM clock
    nvidia-smi reports. The issue limit (4 schedulers x 32 lanes per SM,
    which adds on the FMA pipe can also fill) is twice this."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * max_sm_hz()


def bound(nbytes: float, alu_ops: float, any_ops: float,
          int_rate: float) -> tuple[float, str]:
    """Least milliseconds for the bytes at the memory rate and for the
    ops: ALU-only ops at the ALU rate, all ops at the issue limit."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(alu_ops / int_rate, (alu_ops + any_ops) / (2 * int_rate))
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def trace_events(prof, name: str) -> list:
    """Device spans (start us, end us, name) of a torch.profiler CUDA
    trace, written to build/torch_kernels/<name>.json."""
    from makisu_tpu_torch.ops import _build

    path = _build.BUILD_DIR / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset"))


def queued_event_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls,
    timed by a CUDA-event pair that waits behind a spin kernel while the
    host enqueues the calls, so the pair times the card, not the host's
    enqueue (a G1 launch is shorter than one enqueue)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of spinning at 1,980 MHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_once_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), result


# -- phase 4: kernels against their plain versions --------------------------

def check_gear(torch, np, dev, int_rate, cupti_ms: float) -> dict:
    """``cupti_ms``: G1's median CUPTI duration in the commit's trace,
    where it runs at this launch shape."""
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
    event_ms = queued_event_ms(torch, lambda: gear_cuda.gear_bitmap(x), 50)
    plain_ms = backend.time_cuda_ms(lambda: gear.gear_bitmap(x), reps=5,
                                    warmup=1)
    alu, either = GEAR_OPS_PER_BYTE
    bound_ms, bound_by = bound(n + n / 8, alu * n, either * n, int_rate)
    return {"name": "gear_bitmap", "route": "cuda",
            "source": "makisu_tpu_torch/csrc/gear.cu",
            "replaces": "makisu_tpu/ops/gear_pallas.py:161",
            "also_replaces": "makisu_tpu/ops/gear_pallas.py:283",
            "shape": [n], "words_checked": words, "mismatches": mismatches,
            "max_abs_err": max_err, "ms": cupti_ms,
            "ms_from": "cupti, median launch of the commit's trace",
            "event_pair_ms": event_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / cupti_ms, "library_ms": None}


def ring_pass_spans(np, ends: np.ndarray, ring_bytes: int):
    """(offsets, lengths) of the chunks that end inside the first pass
    over the session's ring, longest first: S1's launch shape."""
    ends = ends[ends <= ring_bytes]
    starts = np.concatenate([[0], ends[:-1]])
    lengths = (ends - starts).astype(np.int32)
    order = np.argsort(-lengths, kind="stable")
    return starts[order].astype(np.int32), lengths[order]


def check_sha(torch, np, dev, int_rate, tar: bytes, ends,
              cupti_ms: float) -> dict:
    """``cupti_ms``: the CUPTI duration of the commit's first S1 launch,
    which hashes these same spans out of the session's ring."""
    from makisu_tpu_torch.chunker.cdc import BLOCK, ChunkSession
    from makisu_tpu_torch.ops import backend, gear, sha256, sha256_cuda

    # Production shape: the chunks of one ring pass of the smoke layer.
    ring_bytes = ChunkSession.RING_BLOCKS * BLOCK
    offsets, lengths = ring_pass_spans(np, np.asarray(ends), ring_bytes)
    buf = torch.frombuffer(bytearray(tar[:ring_bytes]),
                           dtype=torch.uint8).to(dev)
    o = torch.from_numpy(offsets).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    got = sha256_cuda.sha256_spans(buf, o, ln).cpu().numpy()
    sha256_cuda.check_lengths(dev)
    mism_hashlib = int((got != sha256_cuda.hashlib_span_words(
        tar, offsets, lengths)).any(1).sum())
    # The plain version on a seeded 512-span subset (32k spans would
    # take it far too long), against the kernel on the same subset.
    pick = np.sort(np.random.default_rng(11).choice(
        len(offsets), size=min(512, len(offsets)), replace=False))
    so, sl = o[torch.from_numpy(pick).to(dev)], ln[torch.from_numpy(pick)
                                                   .to(dev)]
    plain_ms, want = time_once_ms(torch, lambda: sha256.sha256_spans(
        buf, so, sl))
    want = want.cpu().numpy()
    sub = got[pick]
    mism = int((sub != want).any(1).sum())
    max_err = int(np.abs(sub.astype(np.int64) - want.astype(np.int64))
                  .max())
    check(mism == 0 and mism_hashlib == 0,
          f"sha256 kernel, ring pass: {mism} of {len(pick)} spans differ "
          f"from the plain version, {mism_hashlib} of {len(offsets)} "
          "from hashlib")
    run = lambda: sha256_cuda.sha256_spans(buf, o, ln)  # noqa: E731
    event_ms = queued_event_ms(torch, run, 5)
    subset_ms = queued_event_ms(
        torch, lambda: sha256_cuda.sha256_spans(buf, so, sl), 5)
    nb = (lengths.astype(np.int64) + 9 + 63) // 64
    blocks = int(nb.sum())
    alu, either = SHA_OPS_PER_BLOCK
    spans = len(offsets)
    bound_ms, bound_by = bound(
        int(lengths.sum()) + spans * (SPAN_META_BYTES + DIGEST_BYTES),
        alu * blocks, either * blocks, int_rate)
    chain_floor_ms = int(nb.max()) * SHA_SLOTS_PER_BLOCK / max_sm_hz() * 1e3

    lane_shapes = []
    for lanes, cap in ((512, 16 * 1024), (128, gear.DEFAULT_MAX_SIZE + 64)):
        data, lens = sha256_cuda.probe_inputs(lanes, cap, seed=7)
        d = torch.from_numpy(data).to(dev)
        dl = torch.from_numpy(lens).to(dev)
        lgot = sha256_cuda.sha256_lanes(d, dl).cpu().numpy()
        lplain_ms, lwant = time_once_ms(
            torch, lambda: sha256.sha256_lanes(d, dl))
        lm = int((lgot != lwant.cpu().numpy()).any(1).sum())
        lh = int((lgot != sha256_cuda.hashlib_words(data, lens)).any(1)
                 .sum())
        check(lm == 0 and lh == 0, f"sha256 kernel {lanes}x{cap}: {lm} "
              f"lanes differ from the plain version, {lh} from hashlib")
        lblocks = int(((lens.astype(np.int64) + 9 + 63) // 64).sum())
        lbound, lby = bound(lblocks * 64 + 4 * lanes + 32 * lanes,
                            alu * lblocks, either * lblocks, int_rate)
        lms = backend.time_cuda_ms(lambda: sha256_cuda.sha256_lanes(d, dl),
                                   reps=10, warmup=2)
        lane_shapes.append({"shape": [lanes, cap], "live_blocks": lblocks,
                            "mismatches": lm, "hashlib_mismatches": lh,
                            "ms": lms, "plain_ms": lplain_ms,
                            "bound_ms": lbound, "bound_by": lby})

    # A lane length past cap - 9, and a span past the buffer's end, set
    # the kernel's error flag.
    flagged = []
    data, lens = sha256_cuda.probe_inputs(128, 1024, seed=8)
    lens[3] = 1024 - 8
    sha256_cuda.sha256_lanes(torch.from_numpy(data).to(dev),
                             torch.from_numpy(lens).to(dev))
    sha256_cuda.sha256_spans(buf[:1024], torch.tensor([1000], device=dev),
                             torch.tensor([25], dtype=torch.int32,
                                          device=dev))
    for _ in range(2):
        try:
            sha256_cuda.check_lengths(dev)
            flagged.append(False)
        except ValueError:
            flagged.append(True)
    check(flagged == [True, False], f"sha256 kernel error flag {flagged}")
    return {"name": "sha256_spans", "route": "cuda",
            "source": "makisu_tpu_torch/csrc/sha256.cu",
            "replaces": "makisu_tpu/ops/sha256_pallas.py:52",
            "shape": {"spans": spans, "buffer": ring_bytes,
                      "longest": int(lengths.max()),
                      "live_blocks": blocks},
            "mismatches": mism, "plain_spans": len(pick),
            "hashlib_mismatches": mism_hashlib, "max_abs_err": max_err,
            "ms": cupti_ms,
            "ms_from": "cupti, the commit's first launch (these spans)",
            "event_pair_ms": event_ms, "subset_ms": subset_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / cupti_ms,
            "chain_floor_ms": chain_floor_ms, "library_ms": None,
            "lane_shapes": lane_shapes}


# -- phases 2 and 3: a layer and its commit at real size ---------------------

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


STAGES = (("gear", "gear_bitmap_kernel"), ("sha256", "sha256_spans_kernel"),
          ("h2d", "HtoD"), ("d2h", "DtoH"), ("d2d", "DtoD"),
          ("memset", "Memset"))


def device_trace(prof, wall_s: float) -> dict:
    """Device time per stage, launches per kernel and the card's idle
    share over ``wall_s`` from a CUDA-activity profiler trace."""
    spans = trace_events(prof, "layer_commit_trace")
    check(spans, "the profiler trace holds no device activity")
    stage_ms: dict[str, float] = {}
    count: dict[str, int] = {}
    kernel_ms: dict[str, list] = {"gear": [], "sha256": []}
    busy_us, reach = 0.0, float("-inf")
    for start, end, name in spans:
        stage = next((st for st, key in STAGES if key in name), "other")
        stage_ms[stage] = stage_ms.get(stage, 0.0) + (end - start) / 1e3
        count[stage] = count.get(stage, 0) + 1
        if stage in kernel_ms:
            kernel_ms[stage].append((end - start) / 1e3)
        busy_us += max(0.0, end - max(start, reach))  # union of spans
        reach = max(reach, end)
    busy_ms = busy_us / 1e3
    return {"device_ms": stage_ms, "events": count, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / (wall_s * 1e3),
            "h2d_share": stage_ms.get("h2d", 0.0) / busy_ms,
            "gear_ms_median": sorted(kernel_ms["gear"])[
                len(kernel_ms["gear"]) // 2] if kernel_ms["gear"] else None,
            "sha256_ms_per_launch": kernel_ms["sha256"]}


def layer_commit(torch, np, dev, tar: bytes, want_ends) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from makisu_tpu_torch.chunker.hasher import GPUHasher
    from makisu_tpu_torch.ops import backend, gear_cuda, sha256_cuda

    sha256_cuda.parity_probe(dev)  # its launch is not the commit's
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
    check([c.offset + c.length for c in chunks] == want_ends,
          "chunk cuts differ from the plain Gear version + policy")
    check(gear_launches == session.blocks == -(-len(tar) // (4 * MIB)),
          f"gear launches {gear_launches} != 4 MiB blocks {session.blocks}")
    ring_bytes = session.RING_BLOCKS * session.block
    check(sha_launches == session.span_launches
          == -(-len(tar) // ring_bytes) <= 8,
          f"sha256 launches {sha_launches}, session span launches "
          f"{session.span_launches}, ring passes "
          f"{-(-len(tar) // ring_bytes)} (at most 8)")
    tallies = backend.dispatch_stats()
    check(tallies["launches"] == sha_launches
          and tallies["spans"] == len(chunks)
          and tallies["live_bytes"] == len(tar),
          f"span tallies {tallies['launches']} launches, "
          f"{tallies['spans']} spans, {tallies['live_bytes']} bytes")
    check(session.h2d_bytes == len(tar) + tallies["h2d_bytes"]
          <= 1.01 * len(tar),
          f"session H2D {session.h2d_bytes} bytes for a {len(tar)}-byte "
          "layer")
    check((trace["events"].get("gear"), trace["events"].get("sha256"))
          == (gear_launches, sha_launches),
          f"the trace's kernels {trace['events']} differ from the launch "
          f"counts ({gear_launches}, {sha_launches})")
    distinct = len({c.hex_digest for c in chunks})
    return {"phase": "layer_commit", "bytes": len(tar),
            "chunks": len(chunks), "distinct_chunks": distinct,
            "dedup_ratio": len(chunks) / max(distinct, 1),
            "gzip_bytes": len(blob), "wall_s": wall_s,
            "compress_s": sink.compress_seconds,
            "session_s": session.host_seconds,
            "session_wait_s": session.wait_seconds,
            "session_gb_per_s": len(tar) / session.host_seconds / 1e9,
            "session_h2d_bytes": session.h2d_bytes,
            "h2d_per_layer_byte": session.h2d_bytes / len(tar),
            "trace": trace,
            "launches": {"gear_bitmap": gear_launches,
                         "sha256_spans": sha_launches},
            "span_launches": tallies}


# -- phase 5: the SnapshotHasher module ----------------------------------------

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
    ptxas = {}
    for name in _build.SOURCES:
        log = _build.ptxas_log(name)
        print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", log)]
        check(log and not any(spills),
              f"{name}.cu: ptxas reports spills (or no report): {ptxas[name]}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "ptxas": ptxas})

    t0 = time.perf_counter()
    tar, nfiles = make_layer_tar(np, LAYER_BYTES)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ends = plain_cuts(torch, np, tar, dev)
    emit({"phase": "layer", "bytes": len(tar), "files": nfiles,
          "target_bytes": LAYER_BYTES, "make_tar_s": make_s,
          "oracle_s": time.perf_counter() - t0, "chunks": len(ends)})

    # The commit's trace is the process's first profiler session.
    commit = layer_commit(torch, np, dev, tar, ends.tolist())
    emit(commit)
    trace = commit["trace"]
    kernels = [check_gear(torch, np, dev, int_rate, trace["gear_ms_median"]),
               check_sha(torch, np, dev, int_rate, tar, ends,
                         trace["sha256_ms_per_launch"][0])]
    check(commit["span_launches"]["per_launch"][0]["spans"]
          == kernels[1]["shape"]["spans"],
          "the commit's first S1 launch hashed other spans than one ring "
          "pass")
    emit({"phase": "kernels", "int32_ops_per_s": int_rate,
          "max_sm_hz": max_sm_hz(), "checked": kernels})
    emit(snapshot_hasher(torch, np, dev))

    for kr in kernels:
        kr["launches"] = commit["launches"][kr["name"]]
        check(kr["launches"] > 0, f"{kr['name']} never ran on the main path")
    emit({"kernels": [{k: v for k, v in kr.items() if k != "lane_shapes"}
                      for kr in kernels]})
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
