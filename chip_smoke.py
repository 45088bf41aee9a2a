#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printing one JSON line; any failure exits non-zero:

1. build: compile ``makisu_tpu_torch/csrc/*.cu`` with nvcc and the native
   layer sink and pgzip codec (``csrc/*.cpp``) with g++, all in
   parallel; fails if ptxas reports a spill or a library does not load.
   Prints CPython's zlib version beside the one the native libraries
   linked.
2. layer: make a ~1 GiB layer tar shaped like a node_modules-heavy app
   (about 50k small text-like files, some large binaries, repeated
   contents) and its whole-stream cut oracle (plain Gear on the card +
   the whole-stream min/max policy).
3. layer_commit: the layer streams through ``GPUHasher().open_layer`` in
   16 KiB writes at zlib level 6 into a file, so through the native sink
   (C++ framing, digests and gzip, the stream tapped into the chunk
   session). The sink's route, tar and gzip digests, chunk tiling,
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
   with event pairs queued behind a spin kernel beside them. Then S1's
   multi-buffer entry (the hash service's launch) at the shape of
   config 5's 64-build wave (phase 11 runs 32 of them): 64 rings, each
   the session's guard and one 4 MiB pass of a
   distinct slice of the layer, every span of all of them in one launch,
   against hashlib (all) and the plain version (512 spans), with its
   CUPTI time, in a process of its own (``chip_smoke.py --sha-multi``,
   so its trace is that process's first; the same trace times G1's halo
   entry for phase 15); a span past its own ring's
   end must set the launch's error word. And fault F1's check: two threads, each on a stream of
   its own, one launching a span past its buffer's end and the other a
   good span; only the first raises, the second's digest is hashlib's.
5. snapshot_hasher: ``SnapshotHasher.forward`` at its default shape
   against the plain forward on the card.
6. native_sink: a 64 MiB layer tar from the phase-2 generator (seed 11)
   through the Python sink (``_GPUSink``) and the native one
   (``NativeLayerSink``), each with its own chunk session on the card,
   at zlib-6, zlib-1 and pgzip-6 on 8 lanes: equal blob bytes, tar and
   gzip digests and chunk lists. Then a chunk session that raises
   halfway through the layer: the native sink's ``finish`` raises.
7. build: images built through ``makisu_tpu_torch.cli.main`` with
   ``--hasher gpu``, untraced, with the kernels' launch counts set to 0
   before each build and read after it. Each build leases its session
   from a fresh session manager, as a ``makisu build`` process of its
   own would, so no build here replays an earlier one's scans or layers
   (phase 9 holds the resident sessions). (a) A cold build of a 128 MiB
   app from the phase-2 generator written as a context of files
   (BASELINE.md config 3, cut from 1 GiB for time; 256 MiB before phase
   14 came) with ``--dest``: the
   layer's diff_id against its gunzipped blob, the blob
   against its manifest digest, the cache entry's chunk list tiling the
   tar, every chunk against hashlib, the cuts against the plain oracle,
   G1 once per 4 MiB block and S1 once per ring pass; the layer indexed
   into the chunk CAS (``<storage>/chunks``): exactly the layer's distinct
   digests, each file's sha256 equal to its name, the "indexed" line's
   counts; every layer through the native sink; the stat cache's tally
   all misses; (a) also writes every telemetry artifact (metrics, events,
   ledger, trace, profile, history; stall watchdog at 600 s), and its
   report must hold the span chain build > stage > step > commit_layer,
   gear-scan bytes equal to the layer's tar bytes, one
   ``makisu_device_dispatch_seconds`` observation per S1 launch, an H2D
   counter equal to the sessions' h2d_bytes (at most 1.01 x the layer),
   one ``makisu_chunk_size_bytes`` observation per chunk of the KV entry,
   ``build_info`` on cuda with the kernel route; the parity probe's gauge
   reads ok and the sampler's overhead gauge is at most 0.02. (b) A warm
   rebuild into the same storage, with the same artifacts (no dispatch,
   no gear bytes, every cache consult on its ledger a hit): one cache hit
   on the blob route, no layer committed, no launch, the same layers;
   the stat cache (default 2 s racy window) hits exactly the files that
   (a) hashed 2 s or more after their last change, and re-reads the
   rest. (c) The
   layer blob deleted, then a rebuild with ``--dest``: one lazy hit on
   the chunk route, the layer applied from chunks, no launch, the same
   layers, the blob reconstituted for ``--dest`` equal byte for byte to
   the deleted one, and the tar's layer equal to the layer tar. (d) A
   64 MiB app from the same generator (its own seed and storage) built
   cold, then 16 bytes appended to 1% of its text files and 10 bytes
   inserted at offset 4,096 of one binary, and rebuilt: the COPY step
   commits on the card (the checks of (a)), and the chunks it indexes
   are exactly the new layer's digests absent from the old one's, at
   most 5% of the layer's bytes. (e) A small two-stage build
   (``--modifyfs --commit explicit``: COPY --from, RUN, ADD, every
   metadata directive, ``--gzip-backend auto``) whose layers get the
   checks of (a) and whose cache entries record ``pgzip-6-131072``; run
   under ``--torch-profile``, whose Chrome trace holds as many G1 and S1
   kernels as the build launched.
8. registry: a loopback registry (``makisu_tpu_torch/tools/miniregistry.py``
   on 127.0.0.1, in this process, blobs in memory) and builds with
   ``--hasher gpu --gzip-backend pgzip --push`` to it, counts set to 0
   before each, each build on a fresh session manager as in phase 7.
   (f) A 16 MiB app from the phase-2 generator (seed 13)
   built ``FROM scratch``: the registry's manifest equals the local one
   and every blob there its digest. (g) The phase-2 app at 128 MiB (cut
   from 1 GiB for time; 256 MiB before phase 14 came), written as a config-3 context, built ``FROM``
   that base into a fresh storage: the base pulled
   through the transfer engine and applied; the COPY layer gets the
   checks of (a) (the native sink among them), its commit line names
   ``compress_workers()``, its blob
   is pgzip and the port's own writer reproduces it from the tar; the
   registry holds the layer blob, pack blobs whose members are exactly
   the layer's distinct chunk digests, and pin manifests that pin every
   pack; the KV entry carries the pack map. (h) ``pull`` of the app into
   a fresh storage: manifest, config and layer blobs equal (g)'s byte for
   byte. (i) A fresh storage seeded with (g)'s ``cache_key_value.json``
   only, the app layer's blob deleted from the registry, rebuilt with
   ``--push`` and ``--dest``: one lazy hit served from packs fetched from
   the registry, the layer applied from chunks, no launch, the pgzip blob
   reconstituted byte for byte equal to (g)'s and pushed again.
9. session: one resident process on the card. A 128 MiB app from the
   phase-2 generator (seed 23; cut from 1 GiB for time) dealt into 8
   shard directories, ``FROM scratch`` and one ``COPY shardK/
   /app/shardK/`` each, built through ``cli.main`` with ``--hasher gpu``
   on one session manager (window 0): cold (8 layers, the checks of
   (a)); warm, which records the layers' replay ops (8 inflated);
   warm again (resident: no commit, no launch, every layer replayed,
   every source replayed from the scan memo, no context file read);
   16 bytes appended to 1 file, then to 1% of the text files, of the
   last shard, each rebuilt resident: exactly the last shard's layer
   committed (the checks of (a)), 7 sources and layers replayed, its
   dirty set the edited files, and a session-less build of the same
   tree into a copy of the storage committing the same layer, chunk
   list and image. The card's allocated bytes after each build never
   exceed their value after the cold one. Then ``python -m
   makisu_tpu_torch.cli build --watch --hasher gpu`` as a process of
   its own on a 16 MiB two-shard app: its initial build, one edit,
   "watch: rebuild #2 exited 0", its image against a session-less
   build, one S1 parity probe in that process, and exit code 0 on
   SIGINT.
10. telemetry: ``python -m makisu_tpu_torch.cli`` processes render (a)'s
   and (b)'s artifacts (``report`` with a hash phase above 0, ``explain
   --baseline``, ``explain --metrics``, ``history``, ``profile``); then
   a 1-file build whose RUN step sleeps 8 s, run with ``--stall-timeout
   2 --diag-out F``, exits 0 and leaves a bundle of reason ``stall``
   whose open leaf span is ``step``, which ``doctor F`` names. Prints the
   render times, the bundle's sections and (a)'s and (b)'s ``build
   telemetry`` lines beside their walls.

11. worker: ``python -m makisu_tpu_torch.cli worker --socket S
   --max-concurrent-builds 16`` as a process of its own (its device
   probe, G1 and S1 against their references, waited for) and 32
   ``build --hasher gpu`` requests submitted at once
   (config 5 has 64; cut for time) through ``WorkerClient``, each a
   distinct 4 MiB config-3 context from the phase-2 generator (seeds
   100-131) with its own storage and root: every build exits 0; each COPY layer gets (a)'s layer checks and its
   manifest names it; 4 of the contexts built in this process without
   worker or hash service give the same chunk lists and images; the
   worker's S1 launches are all multi-buffer ones through its hash
   service, fewer than its 32 layer commits, with at least one batch of
   several builds' ring passes (its /metrics), and G1 ran once per 4 MiB
   block; /healthz counts 32 started and succeeded with queue-wait and
   latency percentiles; /builds lists the 32; ``sessions S`` and
   ``alerts S`` render; the card's allocated bytes after the wave are
   within one ring of their value after the probe; ``/exit`` ends the
   worker with rc 0. Prints the wave's wall, latency and queue-wait
   percentiles, batches, passes per batch, launches, the linger and the
   card's peak bytes.

12. distribution: BASELINE.md config 4's cache plane. A monorepo of 8
   service directories (files of 4-192 KiB, four in five text-like) at
   64 MiB (cut from 10 GB for time; 80 MiB before phase 16), built
   ``--commit explicit`` by a Dockerfile of 4 COPY steps (two services
   each): 4 layers. The smoke's RESP
   double (AUTH with a password, GET, SET with EX) on 127.0.0.1 is the
   Redis KV, the port's miniregistry the registry, and two ``python -m
   makisu_tpu_torch.cli worker`` processes A and B (each its own
   storage) are told of each other with ``POST /peers``. (j) A builds v1
   cold with ``--hasher gpu --redis-cache-addr --redis-cache-password
   --push``: 4 layers committed on G1 and S1 (through its hash service),
   every chunk of each layer's published recipe against hashlib on the
   layer's tar, and A's ``/healthz`` serve section counts the 4 recipes
   before B asks. (k) B builds v1 with the Redis flags and no registry:
   4 cache hits, every chunk fetched from A by recipe and ranged packs
   (no per-chunk GET), 0 launches, A's layers. (l) 16 bytes appended to
   1% of one service's files; A builds v2 and pushes: only the dirty
   layer commits. (m) B builds v2: 0 launches, only the novel chunks
   cross the peer wire, at most 5% of the dirty layer's bytes. (n) a
   ``serve --storage <A's storage>`` process; a fresh storage's ``pull
   --delta`` of v1, then of v2, with ``--report-out``: every layer equal
   to the registry's digest, v2's bytes at most 5% of the image. The
   RESP double saw AUTH and SET ... EX; the password is in no file the
   phase wrote, no log and no streamed frame; every process ends with
   rc 0. Prints per-step walls, launches per worker, peer and delta
   bytes and requests, and the KV commands.

13. storage: storage governance over phase 12's worker A storage (its
   chunk CAS, packs, seekable-zstd twins and recipes). (o) ``du --json``
   as a process: the chunk plane's objects equal the smoke's count of
   chunk files and snapshot recipes, the pack tables, zpacks and recipes
   A's last /healthz serve digest. (p) ``doctor --storage DIR``: rc 0 and
   no finding; a scrub re-hashes chunks and a zpack frame. (q) ``doctor
   --storage DIR --eviction-budget N``, N half the hot tier: the dry
   run's victim count equals the census's. (r) a worker C over that
   storage with ``--storage-budget`` N/MiB and ``--storage-remote`` builds
   a new 16 MiB config-3 context cold on G1 and S1: the hot tier is at
   most N after it, every victim the dry run itemized is gone, /healthz
   pressure is at most 1 with evictions counted, ``GET /storage`` carries
   census, audit (demoted chunks, no error), the content store and a
   scrub cycle, and ``doctor --storage SOCKET`` renders it. (s) C builds
   phase 12's v2 with the layer whose chunks (r) demoted missing its
   blob: the chunks come back from the pack or remote tier (``chunk_fetch``
   on the ``tier`` route, refetch bytes counted), no registry or peer
   request, 0 launches, and the ``--dest`` image's layers equal v2's
   diff_ids, its config v2's but for the wall-clock stamps. Prints each
   step's wall, bytes, launches and the eviction's counts.

14. fleet: the port's front door in front of three ``python -m
   makisu_tpu_torch.cli worker`` processes (``--max-concurrent-builds
   4``, each its own storage through ``--worker SOCKET=STORAGE``) and a
   shared HTTP KV (``fleet/kv.py``): ``python -m makisu_tpu_torch.cli
   --events-out E --trace-out T fleet --socket F ... --tenant-quota 2
   --canary-interval 5`` (canaries on the card). Six config-3 contexts
   (seeds 61-66, 4 MiB each, cut as phase 11's), two tenants, all six
   submitted at once per round through ``WorkerClient(F)``; the front
   door at its default spillover depth (2). (t) cold: every build exits
   0 on its context's ring owner (the port's ``FleetScheduler``), or,
   with reason ``overloaded``, on the least-loaded worker; one layer
   committed each. (u) 16 bytes appended to 1% of each context's files:
   every verdict ``affinity`` on (t)'s worker, one dirty layer committed
   each; then every layer in each worker's storage gets (a)'s layer
   checks (chunks against hashlib, cuts against the plain Gear version),
   and each worker's G1 launches equal the 4 MiB blocks of the layers it
   committed (its builds' and its canary's), its S1 launches its hash
   batches. (v) ``POST /drain`` of context 0's holder; a 1 MiB context
   with ``RUN sleep 3`` (then its COPY) routed to a second worker,
   SIGKILLed while the
   build runs there: the build fails over mid-stream to the third
   (verdict ``failover``, two attempts or more). (w) the six unchanged:
   exit 0, the drained and killed workers' contexts on the survivor
   (``spillover`` or ``failover``), the rest ``affinity``; every layer
   equal to (u)'s and to a worker-less ``build --hasher gpu`` process's
   of the same context (the seven, (v)'s too, run beside (w)); the
   layer checks again over every worker's storage; peer chunk hits or a
   prewarm; G1 and S1 launches per worker from /healthz; a canary per
   alive worker. (x) ``top --once`` (a row per worker), ``doctor
   --fleet`` (names the killed worker), ``alerts`` and ``profile
   --fleet`` as processes; ``/exit``; ``report --fleet E``; T with one
   trace id per routed build. (y) ``loadgen --fleet --workers 3 --rounds
   3 --hasher gpu`` as a process at its own template sizes, started with
   the phase and run beside (t)-(x): rc 0, every digest identical, the
   killed worker's builds completed elsewhere (its kill falls between
   rounds, as the reference harness's does, so they relocate rather than
   fail over mid-stream). Prints each step's wall with the card's
   name and power limit.

15. parallel: the sharded hash step (``makisu_tpu_torch/parallel/``).
   G1's halo entry against its plain version and the unsharded stream
   (masks of 13, 4 and 1 bits, lengths ending mid-tile and the [2, 2
   MiB] production shard), with its CUPTI time there from phase 4's
   multi-buffer process (whose one profiler session also times it).
   (a) A (1, 1) mesh
   over a one-rank NCCL group in this process at the reference dry run's
   production shape (4 MiB blocks, 2 lanes of 2,048). (b) The dry run
   (``parallel/dryrun.py``): 4 rank processes sharing the card over gloo
   (NCCL refuses two ranks on one device), the halo crossing through
   the host, meshes (2, 2) and (1, 4) at its tiny and production shapes,
   and (c) SnapshotHasher's default lanes (1,024 x 16 KiB, 1 MiB blocks)
   on (2, 2). Every gathered bitmap and digest equals the single-card
   forward, the plain versions and hashlib bit for bit; each rank's two
   steps launch G1 once and S1's lane entry once each, the halo entry on
   every shard past seq index 0 (counted around each step, in each
   rank); no bytes are left on the card and no rank alive after. Prints
   each rank's step times (CUDA events) with the card's name and power
   limit.

16. device_plane: the bounded device plane (``ops/backend.py``), each
   part's ledger and wedge cache in temporary directories. (a) ``python
   -m makisu_tpu_torch.cli build --hasher gpu`` on a 4 MiB config-3
   context (seed 71) as a process of its own: its ledger holds one
   ``ok`` record with the five probe phases ok and timed, ``doctor
   --device DIR`` exits 0 naming it, and the layer gets (a)'s layer
   checks. (b) In this process, ``torch.cuda._sleep`` for ~2 s of
   cycles on a chunk session's stream stands in for a hung kernel:
   ``sync_bounded`` on an event behind it raises ``TimeoutError`` within
   1 s of its 0.25 s bound; the session, fed three blocks under
   ``MAKISU_TPU_SYNC_TIMEOUT=0.5``, raises naming the gear bitmap
   readback and keeps no ring; after the drain G1 on that stream equals
   its plain version and the card's allocated bytes equal their value
   before the session. (c) ``chip_smoke.py --probe-child wedge`` parks
   ``_phase_context_init`` on an event under ``MAKISU_TPU_PROBE_TIMEOUT=1``:
   ``backend_ready()`` returns the wedge summary within 2 s, the ledger
   holds a ``wedged`` record naming ``context_init`` with its stack
   samples, and the wedge cache exists; then ``--probe-child after``,
   unpatched, is ready within its grace, clears the cache and records
   ``ok``; ``doctor --device`` names the wedge. Beside them ``--probe-child
   cold`` points the kernels' build directory at an empty one, so its
   ``kernel_build`` phase runs nvcc. Prints each part's seconds and the
   probe phases' seconds with the card's name and power limit.

Then the kernels' summary line (launches counted on every main path),
the smoke's total seconds, the card's name and power limit as nvidia-smi
reports them, and the final ``{"ok": true, ...}`` line. Needs one card;
exits non-zero without CUDA or outside the repository.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import re
import shutil
import signal
import stat
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import traceback
import zlib

MIB = 1 << 20
LAYER_BYTES = 1024 * MIB
EDIT_BYTES = 64 * MIB  # the edit rebuild's app, cut from 1 GiB for time
LOCAL_BYTES = 128 * MIB  # the app of phase build (a)-(c), cut for time
REGISTRY_BYTES = 128 * MIB  # the app of phase registry (g)-(i), cut for time
SESSION_BYTES = 128 * MIB  # the app of phase session, cut for time
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


WAVE_BUILDS = 32            # phase 11: config 5's 64 build jobs, cut for time
WAVE_CONTEXT_BYTES = 4 * MIB  # each wave (and fleet) context, config-3 shaped
# The multi-buffer S1 check's rings: config 5's full wave of 64, kept
# so the kernel's time stays comparable from run to run.
MULTI_RINGS = 64
MULTI_META_BYTES = 32       # int64 base, offset, length, request per span


def wave_rings(torch, np, dev, tar: bytes):
    """The rings a wave of worker builds hands the hash service: for
    each of MULTI_RINGS sessions a ring of its guard and one pass of
    WAVE_CONTEXT_BYTES stream bytes (a distinct slice of the smoke
    layer) behind it, with the spans of that pass (the slice's plain
    cuts). Returns (slices, rings, index, offsets, lengths, guard), the
    spans longest first across the rings."""
    from makisu_tpu_torch.chunker.cdc import HALO
    from makisu_tpu_torch.ops import gear

    guard = HALO + -(-gear.DEFAULT_MAX_SIZE // 64) * 64
    slices, rings, index, offsets, lengths = [], [], [], [], []
    for r in range(MULTI_RINGS):
        piece = tar[r * WAVE_CONTEXT_BYTES:(r + 1) * WAVE_CONTEXT_BYTES]
        ring = torch.zeros(guard + WAVE_CONTEXT_BYTES, dtype=torch.uint8,
                           device=dev)
        ring[guard:guard + len(piece)].copy_(torch.frombuffer(
            bytearray(piece), dtype=torch.uint8))
        ends = plain_cuts(torch, np, piece, dev)
        starts = np.concatenate([[0], ends[:-1]])
        slices.append(piece)
        rings.append(ring)
        index.append(np.full(len(ends), r, np.int64))
        offsets.append(guard + starts.astype(np.int64))
        lengths.append((ends - starts).astype(np.int64))
    index, offsets, lengths = (np.concatenate(a)
                               for a in (index, offsets, lengths))
    order = np.argsort(-lengths, kind="stable")
    return slices, rings, index[order], offsets[order], lengths[order], \
        guard


def check_sha_multi(torch, np, dev, int_rate, tar: bytes) -> dict:
    """S1's multi-buffer entry (the hash service's launch) at the worker
    wave's shape: MULTI_RINGS rings of the session's size, one pass of
    WAVE_CONTEXT_BYTES each, all their spans in one launch, held against
    hashlib (every span) and the plain version (a 512-span subset), with
    its CUPTI time; then a span past its own ring's end (inside another
    ring of the launch) must set the launch's error word."""
    from torch.profiler import ProfilerActivity, profile

    from makisu_tpu_torch.ops import sha256, sha256_cuda

    from makisu_tpu_torch.ops import gear_cuda

    slices, rings, index, offsets, lengths, guard = wave_rings(
        torch, np, dev, tar)
    errors = sha256_cuda.LaunchErrors()
    run = lambda: sha256_cuda.sha256_multi(  # noqa: E731
        rings, index, offsets, lengths, errors=errors)
    x, h = halo_shard(torch, np, dev)
    run()
    gear_cuda.gear_bitmap(x, halo=h)
    torch.cuda.synchronize()
    # The process's one profiler session also times G1's halo entry at
    # phase 15's production shard.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            got = run()
        for _ in range(9):
            gear_cuda.gear_bitmap(x, halo=h)
        torch.cuda.synchronize()
    trace = trace_events(prof, "sha256_multi_trace")
    spans_trace = sorted(e[1] - e[0] for e in trace
                         if "sha256_multi_kernel" in e[2])
    check(len(spans_trace) == 3, f"the multi-buffer launches' trace holds "
          f"{len(spans_trace)} of their 3 kernels")
    cupti_ms = spans_trace[1] / 1e3  # the median launch
    halo_trace = sorted(e[1] - e[0] for e in trace
                        if "gear_bitmap_kernel" in e[2])
    check(len(halo_trace) == 9, f"the trace holds {len(halo_trace)} of the "
          "halo entry's 9 G1 launches")
    got = got.cpu().numpy()
    errors.check()
    raw = b"".join(hashlib.sha256(memoryview(slices[r])[o - guard:
                                                        o - guard + n])
                   .digest() for r, o, n in zip(index.tolist(),
                                                offsets.tolist(),
                                                lengths.tolist()))
    want_hashlib = np.frombuffer(raw, ">u4").astype(np.uint32).reshape(-1, 8)
    mism_hashlib = int((got != want_hashlib).any(1).sum())
    pick = np.sort(np.random.default_rng(12).choice(
        len(offsets), size=min(512, len(offsets)), replace=False))
    plain_ms, want = time_once_ms(torch, lambda: sha256.sha256_multi(
        rings, torch.from_numpy(index[pick]), torch.from_numpy(offsets[pick]),
        torch.from_numpy(lengths[pick])))
    want = want.cpu().numpy()
    mism = int((got[pick] != want).any(1).sum())
    max_err = int(np.abs(got[pick].astype(np.int64)
                         - want.astype(np.int64)).max())
    check(mism == 0 and mism_hashlib == 0,
          f"sha256 multi-buffer kernel: {mism} of {len(pick)} spans differ "
          f"from the plain version, {mism_hashlib} of {len(offsets)} from "
          "hashlib")
    event_ms = queued_event_ms(torch, run, 5)
    errors.check()
    nb = (lengths + 9 + 63) // 64
    blocks = int(nb.sum())
    alu, either = SHA_OPS_PER_BLOCK
    spans = len(offsets)
    bound_ms, bound_by = bound(
        int(lengths.sum()) + spans * (MULTI_META_BYTES + DIGEST_BYTES)
        + 8 * len(rings), alu * blocks, either * blocks, int_rate)
    # A span of ring 0 past its end, though inside the larger ring 1.
    bad = sha256_cuda.LaunchErrors()
    small = rings[0][:1024]
    sha256_cuda.sha256_multi([small, rings[1]], [1, 0], [0, 1000],
                             [100, 100], errors=bad)
    try:
        bad.check()
        flagged = False
    except ValueError:
        flagged = True
    check(flagged, "the multi-buffer kernel did not flag a span outside "
          "its own ring")
    return {"name": "sha256_multi", "route": "cuda",
            "source": "makisu_tpu_torch/csrc/sha256.cu",
            "replaces": "makisu_tpu/ops/sha256_pallas.py:52",
            "shape": {"rings": len(rings), "spans": spans,
                      "ring_bytes": rings[0].numel(),
                      "pass_bytes": WAVE_CONTEXT_BYTES,
                      "longest": int(lengths.max()), "live_blocks": blocks},
            "mismatches": mism, "plain_spans": len(pick),
            "hashlib_mismatches": mism_hashlib, "max_abs_err": max_err,
            "ms": cupti_ms, "ms_from": "cupti, median of 3 launches at the "
            "wave's shape", "event_pair_ms": event_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / cupti_ms,
            "chain_floor_ms": int(nb.max()) * SHA_SLOTS_PER_BLOCK
            / max_sm_hz() * 1e3, "library_ms": None,
            "flags_span_outside_its_ring": flagged,
            "gear_halo_cupti_ms": halo_trace[4] / 1e3}


def sha_multi_process() -> dict:
    """``check_sha_multi`` in a process of its own, on the phase-2
    generator's app at MULTI_RINGS x 4 MiB: there its trace is
    the process's first profiler session. (In the smoke's process, after
    the commit's session, such a trace kept 1 of 3 launches' kernels,
    measured on one H100.)"""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--sha-multi"], capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"the multi-buffer check exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sha_multi_main() -> int:
    """``chip_smoke.py --sha-multi``: ``check_sha_multi`` alone."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    tar, _ = make_layer_tar(np, MULTI_RINGS * WAVE_CONTEXT_BYTES)
    emit(check_sha_multi(torch, np, dev, int32_ops_per_s(torch), tar))
    return 0


def check_launch_errors_per_stream(torch, np, dev) -> dict:
    """Fault F1's check: two threads, each on a stream of its own; one
    launches S1 over a span past its buffer's end, the other over a good
    span. Only the first raises (even though the second checks first),
    and the second's digest equals hashlib's."""
    import threading

    from makisu_tpu_torch.ops import sha256_cuda

    data = np.random.default_rng(13).integers(0, 256, size=8192,
                                              dtype=np.uint8)
    launched = threading.Barrier(2)
    good_checked = threading.Event()
    out = {}

    def run(name, offset, length):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            buf = torch.from_numpy(data).to(dev)
            got = sha256_cuda.sha256_spans(
                buf, torch.tensor([offset], device=dev),
                torch.tensor([length], dtype=torch.int32, device=dev))
            launched.wait(timeout=60)
            if name == "bad":
                good_checked.wait(timeout=60)
            try:
                sha256_cuda.check_lengths(dev)
                out[name] = got.cpu().numpy()
            except ValueError as e:
                out[name] = str(e)
            if name == "good":
                good_checked.set()

    threads = [threading.Thread(target=run, args=("bad", 8000, 500)),
               threading.Thread(target=run, args=("good", 17, 5000))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    want = np.frombuffer(hashlib.sha256(data[17:5017].tobytes()).digest(),
                         dtype=">u4")
    good_ok = not isinstance(out.get("good"), str) \
        and bool((out["good"][0] == want).all())
    check(isinstance(out.get("bad"), str) and good_ok,
          f"per-launch error words: bad thread {out.get('bad')!r}, good "
          f"thread's digest equal to hashlib: {good_ok}")
    return {"bad_thread_raised": True, "good_thread_digest_ok": good_ok}


# -- phases 2 and 3: a layer and its commit at real size ---------------------

def layer_files(np, target: int, seed: int = 3):
    """(name, content) of a deterministic app of about ``target`` tar
    bytes shaped like a node_modules-heavy app: small text-like files
    (log-uniform 1-64 KiB, one in seven repeating an earlier file) until
    ~75% of the target, then random-byte binaries of 4-16 MiB."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    vocab = [bytes(letters[rng.integers(0, 26, size=int(k))])
             for k in rng.integers(2, 10, size=4000)]
    vocab += [b"function", b"return", b"const", b"require(", b"});\n",
              b"module.exports", b"=>", b"{\n", b"\n"]
    pick = np.minimum(rng.zipf(1.3, size=(8 * MIB) // 5), len(vocab)) - 1
    pool = b" ".join(vocab[i] for i in pick.tolist())
    total = 0  # tar bytes so far: a header and the padded content each
    texts = []  # (pool offset, size) of each text file, for repeats
    k = 0
    while total < 0.75 * target:
        if len(texts) > 8 and rng.random() < 1 / 7:
            at, size = texts[int(rng.integers(0, len(texts)))]
        else:
            size = int(np.exp(rng.uniform(np.log(1024), np.log(65536))))
            at = int(rng.integers(0, len(pool) - size))
            texts.append((at, size))
        yield (f"app/node_modules/pkg{k // 40:04d}/lib/f{k:05d}.js",
               pool[at:at + size])
        total += 512 + -(-size // 512) * 512
        k += 1
    b = 0
    while total < target:
        size = min(int(rng.integers(4 * MIB, 16 * MIB)),
                   max(target - total, 1))
        yield (f"app/bin/blob{b:03d}.bin",
               rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
        total += 512 + -(-size // 512) * 512
        b += 1


def make_layer_tar(np, target: int, seed: int = 3) -> tuple[bytes, int]:
    """``layer_files`` as one layer tar. Returns (tar, file count)."""
    out = io.BytesIO()
    nfiles = 0
    with tarfile.open(fileobj=out, mode="w", format=tarfile.PAX_FORMAT) as tf:
        for name, content in layer_files(np, target, seed):
            info = tarfile.TarInfo(name)
            info.size = len(content)
            info.mode = 0o644
            tf.addfile(info, io.BytesIO(content))
            nfiles += 1
    return out.getvalue(), nfiles


def write_context(np, path: str, target: int, seed: int = 3,
                  shards: int = 0) -> tuple[int, int]:
    """``layer_files`` as files under ``path``, written by 8 threads in
    batches (the file system's per-file cost, not the bytes, sets the
    time); with ``shards``, file i goes under ``shard{i % shards}/``.
    Returns (files, bytes)."""
    from concurrent.futures import ThreadPoolExecutor

    def write(item) -> None:
        k, (name, content) = item
        if shards:
            name = f"shard{k % shards}/{name}"
        dst = os.path.join(path, name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(content)

    nfiles = nbytes = 0
    batch: list = []
    with ThreadPoolExecutor(8) as pool:
        for item in layer_files(np, target, seed):
            batch.append((nfiles, item))
            nfiles += 1
            nbytes += len(item[1])
            if len(batch) == 512:
                list(pool.map(write, batch))
                batch = []
        list(pool.map(write, batch))
    return nfiles, nbytes


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


def layer_commit(torch, np, dev, tar: bytes, want_ends, work: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from makisu_tpu_torch.chunker.hasher import GPUHasher
    from makisu_tpu_torch.ops import backend, gear_cuda, sha256_cuda

    # The device plane's probe (G1 and S1 in its first dispatch): its
    # launches are not the commit's.
    summary = backend.backend_ready()
    check(summary is None, f"the device plane did not come up: {summary}")
    path = os.path.join(work, "layer_commit.gz")
    backend.reset_span_launch_stats()
    gear_cuda.launches = sha256_cuda.launches = 0
    with open(path, "wb") as out, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sink = GPUHasher(device=dev).open_layer(out, backend_id="zlib-6")
        for i in range(0, len(tar), 16 * 1024):
            sink.write(tar[i:i + 16 * 1024])
        commit = sink.finish()
        wall_s = time.perf_counter() - t0
    gear_launches, sha_launches = gear_cuda.launches, sha256_cuda.launches
    session = sink.session
    trace = device_trace(prof, wall_s)
    check(sink.route == "native", f"the commit took the {sink.route} sink")

    pair = commit.digest_pair
    check(pair.tar_digest.hex() == hashlib.sha256(tar).hexdigest(),
          "tar digest differs from hashlib")
    with open(path, "rb") as f:
        blob = f.read()
    os.unlink(path)
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
    tallies = backend.span_launch_stats()
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
    return {"phase": "layer_commit", "sink": sink.route, "bytes": len(tar),
            "chunks": len(chunks), "distinct_chunks": distinct,
            "dedup_ratio": len(chunks) / max(distinct, 1),
            "gzip_bytes": len(blob), "wall_s": wall_s,
            "compress_s": sink.compress_seconds,
            "native_s": sink.handle.native_seconds,
            "tap_s": sink.handle.tap_seconds,
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


# -- phase 6: the native layer sink against the Python one ---------------------

NATIVE_SINK_BYTES = 64 * MIB
NATIVE_SINK_IDS = ("zlib-6", "zlib-1", "pgzip-6-131072")


class _TapFault:
    """A chunk session whose ``update`` raises once ``after`` bytes have
    passed it (the rest of the session is the real one's)."""

    def __init__(self, session, after: int) -> None:
        self.session, self.after, self.seen = session, after, 0

    def update(self, data) -> None:
        self.seen += len(data)
        if self.seen > self.after:
            raise RuntimeError("injected chunk-session failure")
        self.session.update(data)


def native_sink_phase(torch, np, dev, work: str) -> dict:
    """A 64 MiB config-3 layer tar through the Python sink (``_GPUSink``)
    and the native one (``NativeLayerSink``), each with its own chunk
    session on the card, at zlib-6, zlib-1 and pgzip-6 on 8 lanes: the
    same blob bytes, digests and chunk lists. Then a chunk session that
    fails mid-layer: the native sink's finish must raise."""
    from makisu_tpu_torch.chunker import hasher
    from makisu_tpu_torch.chunker.cdc import ChunkSession
    from makisu_tpu_torch.utils import concurrency

    tar, nfiles = make_layer_tar(np, NATIVE_SINK_BYTES, seed=11)
    want_tar = hashlib.sha256(tar).hexdigest()
    token = concurrency.set_compress_workers(8)
    rows = []
    try:
        for backend_id in NATIVE_SINK_IDS:
            got = {}
            for route in ("python", "native"):
                path = os.path.join(work, f"native-sink-{route}.gz")
                session = ChunkSession(device=dev)
                with open(path, "wb") as out:
                    t0 = time.perf_counter()
                    if route == "native":
                        sink = hasher.NativeLayerSink(out, backend_id,
                                                      session=session)
                    else:
                        sink = hasher._GPUSink(out, session, backend_id)
                    for i in range(0, len(tar), 16 * 1024):
                        sink.write(tar[i:i + 16 * 1024])
                    commit = sink.finish()
                    wall_s = time.perf_counter() - t0
                with open(path, "rb") as f:
                    blob = f.read()
                os.unlink(path)
                got[route] = {
                    "blob": hashlib.sha256(blob).hexdigest(),
                    "blob_bytes": len(blob),
                    "tar": commit.digest_pair.tar_digest.hex(),
                    "gzip": commit.digest_pair.gzip_descriptor.digest.hex(),
                    "chunks": [(c.offset, c.length, c.hex_digest)
                               for c in commit.chunks],
                    "wall_s": wall_s, "session_s": session.host_seconds,
                    "gear_blocks": session.blocks,
                    "span_launches": session.span_launches}
                check(gzip.decompress(blob) == tar,
                      f"{backend_id} {route}: the blob does not inflate "
                      "to the tar")
            py, nat = got["python"], got["native"]
            check(py["tar"] == nat["tar"] == want_tar
                  and py["gzip"] == nat["gzip"] == py["blob"] == nat["blob"]
                  and py["blob_bytes"] == nat["blob_bytes"],
                  f"{backend_id}: the sinks' blobs or digests differ: "
                  f"python {py['blob']} {py['blob_bytes']}, native "
                  f"{nat['blob']} {nat['blob_bytes']}")
            check(py["chunks"] == nat["chunks"] and len(py["chunks"]) > 100,
                  f"{backend_id}: the sinks' chunk lists differ")
            rows.append({"backend_id": backend_id,
                         "blob_bytes": nat["blob_bytes"],
                         "chunks": len(nat["chunks"]),
                         **{f"{r}_{k}": got[r][k] for r in got
                            for k in ("wall_s", "session_s", "gear_blocks",
                                      "span_launches")}})
        # A chunk session failing mid-layer fails the native commit.
        path = os.path.join(work, "native-sink-fault.gz")
        fault = _TapFault(ChunkSession(device=dev), after=len(tar) // 2)
        raised = []
        with open(path, "wb") as out:
            sink = hasher.NativeLayerSink(out, "zlib-6", session=fault)
            for i in range(0, len(tar), 16 * 1024):
                try:
                    sink.write(tar[i:i + 16 * 1024])
                except RuntimeError as e:
                    raised.append(("write", i, str(e)))
                    break
            try:
                sink.finish()
            except RuntimeError as e:
                raised.append(("finish", None, str(e)))
        os.unlink(path)
        check(raised and raised[-1][0] == "finish"
              and all("tap failed" in r[2] for r in raised),
              f"a failing chunk session did not fail the commit: {raised}")
    finally:
        concurrency.reset_compress_workers(token)
    return {"phase": "native_sink", "bytes": len(tar), "files": nfiles,
            "compress_workers": 8, "backends": rows,
            "tap_fault": [r[:2] for r in raised]}


# -- phase 7: images built through the port's command line -------------------

CONFIG3_DOCKERFILE = """\
FROM scratch
COPY . /app/
ENV NODE_ENV=production
WORKDIR /app
ENTRYPOINT ["node","server.js"]
"""

SMALL_DOCKERFILE = """\
FROM scratch AS build
COPY app /work/app/
RUN cat work/app/bin/*.bin > work/blob.bin && echo built > work/f.txt #!COMMIT
FROM scratch
ARG NAME=smoke
COPY --from=build /work/blob.bin /work/f.txt /srv/
ADD app/node_modules /srv/node_modules/
RUN echo "$NAME" > srv/name.txt #!COMMIT
ENV NODE_ENV=production
LABEL stage=final
EXPOSE 8080
VOLUME /data
STOPSIGNAL 15
HEALTHCHECK --interval=30s CMD ["true"]
USER 1000
WORKDIR /srv
CMD ["server.js"]
ENTRYPOINT ["node"]
"""


def run_build(storage: str, root: str, ctx: str, tag: str, log: str,
              *extra: str, manager=None, telemetry=()) -> dict:
    """One ``makisu_tpu_torch.cli`` build on the card with the kernels'
    launch counts set to 0 just before it and read just after. Returns
    the wall seconds, the launches and the build's log records. The
    build leases its session from ``manager``; by default a fresh one,
    as a ``makisu build`` process of its own would (no session of an
    earlier build replays its scans or layers). ``telemetry`` holds the
    command's global telemetry flags (``--metrics-out`` and the rest)."""
    from makisu_tpu_torch import cli
    from makisu_tpu_torch.ops import gear_cuda, sha256_cuda
    from makisu_tpu_torch.worker import session

    os.makedirs(root, exist_ok=True)
    argv = ["--log-fmt", "json", "--log-output", log, *telemetry, "build",
            ctx, "-t", tag, "--hasher", "gpu", "--storage", storage,
            "--root", root, *extra]
    token = session.bind_manager(manager or session.SessionManager())
    gear_cuda.launches = sha256_cuda.launches = 0
    start = time.time()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        session.reset_manager(token)
    wall_s = time.perf_counter() - t0
    launches = {"gear_bitmap": gear_cuda.launches,
                "sha256_spans": sha256_cuda.launches}
    with open(log) as f:
        records = [json.loads(line) for line in f]
    errors = [r["msg"] for r in records if r["level"] == "error"]
    check(rc == 0, f"build of {tag} exited {rc}: {errors}")
    # Phases from the log's timestamps: parsing and the context's cache
    # IDs before the first stage; the first layer's index into the chunk
    # CAS after its commit line; a cached layer's application up to its
    # step's end; the blob reconstitution and the docker-save tar after
    # the build.
    first = {}
    for r in records:
        for key in ("stage 1/", "committed layer ", "indexed ",
                    "applying cached layer", "reconstituted layer",
                    "successfully built image", "saved image tar"):
            if r["msg"].startswith(key):
                first.setdefault(key, r["ts"])
    phases = {"plan_s": first["stage 1/"] - start,
              "step_s": [r["duration"] for r in records
                         if r["msg"].startswith("step ")
                         and r["msg"].endswith(" done")]}
    if "indexed " in first:
        phases["index_s"] = first["indexed "] - first["committed layer "]
    if "applying cached layer" in first:
        t = first["applying cached layer"]
        phases["apply_s"] = min(
            r["ts"] for r in records if r["ts"] >= t
            and r["msg"].startswith("step ")
            and r["msg"].endswith(" done")) - t
    built = first["successfully built image"]
    if "reconstituted layer" in first:
        phases["reconstitute_s"] = first["reconstituted layer"] - built
        built = first["reconstituted layer"]
    if "saved image tar" in first:
        phases["dest_s"] = first["saved image tar"] - built
    return {"wall_s": wall_s, "launches": launches, "records": records,
            "phases": phases}


def commits(build: dict) -> list[dict]:
    return [r for r in build["records"]
            if r["msg"].startswith("committed layer ")]


def check_native_sink(build: dict) -> None:
    """Every layer the build committed went through the native sink."""
    sinks = [r["sink"] for r in commits(build)]
    check(sinks and set(sinks) == {"native"},
          f"committed layers took the sinks {sinks}, not the native one")


def stat_tally(build: dict) -> dict:
    """The build's one stat-cache tally (a single COPY step)."""
    [rec] = [r for r in build["records"]
             if r["msg"].startswith("stat cache for ")]
    return {k: rec[k] for k in ("files", "hits", "misses",
                                "misses_by_reason", "bytes_rehashed")}


def trusted_entries(storage: str, ctx: str) -> tuple[int, int]:
    """(entries, entries outside the racy window) of the stat cache's
    namespace for context ``ctx``: an entry is trusted when the file's
    newest timestamp predates its hash by at least the default window
    (2 s), as ``utils/statcache.py`` decides."""
    from makisu_tpu_torch.utils import statcache

    with open(os.path.join(storage, "content_id_cache.json")) as f:
        entries = json.load(f)["entries"]
    ns = os.path.abspath(ctx) + "\x00"
    mine = [v for k, v in entries.items() if k.startswith(ns)]
    trusted = sum(v[2] - max(v[0][1], v[0][2]) >= statcache.RACY_WINDOW_NS
                  for v in mine)
    return len(mine), trusted


def image_layers(storage: str, tag: str) -> tuple[list, list]:
    """(manifest layer descriptors, diff_ids) of a stored image."""
    repo, _, name = tag.rpartition(":")
    with open(os.path.join(storage, "manifests", repo, name + ".json")) as f:
        manifest = json.load(f)
    cfg = manifest["config"]["digest"].split(":")[1]
    with open(os.path.join(storage, "layers", cfg[:2], cfg), "rb") as f:
        config = json.load(f)
    return manifest["layers"], config["rootfs"]["diff_ids"]


def layer_entries(values) -> dict[str, dict]:
    """gzip digest -> cache entry of every layer among KV values."""
    entries = [json.loads(value) for value in values
               if value.startswith("{")]
    return {e["gzip"]: e for e in entries}


def kv_layers(storage: str) -> dict[str, dict]:
    """gzip digest -> cache entry of every layer in the storage's KV."""
    with open(os.path.join(storage, "cache_key_value.json")) as f:
        return layer_entries(value for value, _ts in json.load(f).values())


def check_committed_layers(torch, np, dev, storage: str, only=None,
                           entries: dict | None = None) -> list[dict]:
    """Every layer with a cache entry in the storage's KV file (or those
    of ``only``, gzip digests): its blob digest and size, the tar under
    it, the entry's chunk list tiling the tar, each chunk against hashlib
    and the cut ends against the plain cut oracle. Returns one row per
    layer. ``entries`` (``layer_entries`` of a shared KV) replaces the
    file: then the layers whose blob the storage holds are checked."""
    rows = []
    for entry in (kv_layers(storage) if entries is None
                  else entries).values():
        if only is not None and entry["gzip"] not in only:
            continue
        hexd = entry["gzip"].split(":")[1]
        if entries is not None and not os.path.exists(
                os.path.join(storage, "layers", hexd[:2], hexd)):
            continue
        with open(os.path.join(storage, "layers", hexd[:2], hexd), "rb") as f:
            blob = f.read()
        check(hashlib.sha256(blob).hexdigest() == hexd
              and len(blob) == entry["size"], f"blob {hexd} differs from "
              "its digest")
        tar = gzip.decompress(blob)
        check("sha256:" + hashlib.sha256(tar).hexdigest() == entry["tar"],
              f"layer {hexd}: diff_id differs from the gunzipped blob")
        chunks = entry["chunks"]
        pos = 0
        for off, n, _ in chunks:
            check(off == pos and n > 0, f"layer {hexd}: chunk gap at {pos}")
            pos += n
        check(pos == len(tar), f"layer {hexd}: chunks do not tile the tar")
        mv = memoryview(tar)
        bad = sum(hashlib.sha256(mv[off:off + n]).hexdigest() != h
                  for off, n, h in chunks)
        check(bad == 0, f"layer {hexd}: {bad} chunk digests differ from "
              "hashlib")
        check([off + n for off, n, _ in chunks]
              == plain_cuts(torch, np, tar, dev).tolist(),
              f"layer {hexd}: cuts differ from the plain Gear version")
        rows.append({"gzip": entry["gzip"], "tar": entry["tar"],
                     "bytes": len(tar), "gzip_bytes": len(blob),
                     "chunks": len(chunks),
                     "distinct_chunks": len({h for _, _, h in chunks})})
    return rows


def committed_digests(build: dict) -> set[str]:
    """gzip digests of the layers a build committed."""
    return {r["msg"].split()[2] for r in commits(build)}


def cas_names(root: str) -> set[str]:
    return {name for shard in os.listdir(root) if shard != "_tmp"
            for name in os.listdir(os.path.join(root, shard))}


def check_chunk_cas(root: str, want: set[str]) -> dict:
    """The chunk CAS holds exactly ``want``, each file under its name's
    first two hex digits and with a sha256 equal to its name (read and
    hashed by 8 threads)."""
    from concurrent.futures import ThreadPoolExecutor

    def verify(item) -> tuple[bool, int]:
        shard, name = item
        with open(os.path.join(root, shard, name), "rb") as f:
            data = f.read()
        return (hashlib.sha256(data).hexdigest() == name
                and shard == name[:2], len(data))

    files = [(shard, name) for shard in os.listdir(root) if shard != "_tmp"
             for name in os.listdir(os.path.join(root, shard))]
    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(verify, files, chunksize=256))
    names = len(results)
    nbytes = sum(n for _, n in results)
    bad = sum(not ok for ok, _ in results)
    check(bad == 0, f"{bad} chunk CAS files differ from their names")
    check(names == len(want) and cas_names(root) == want,
          f"the chunk CAS holds {names} files, the layers {len(want)} "
          "distinct digests")
    return {"files": names, "bytes": nbytes}


def indexed(build: dict) -> dict:
    [rec] = [r for r in build["records"] if r["msg"].startswith("indexed ")]
    return {k: rec[k] for k in ("chunks", "added", "bytes_total",
                                "bytes_added", "bytes_reused")}


def sha256_file(path: str) -> tuple[str, int]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while piece := f.read(16 * MIB):
            h.update(piece)
            size += len(piece)
    return h.hexdigest(), size


def edit_context(np, ctx: str, seed: int) -> dict:
    """Append 16 bytes to 1% of the app's text files (chosen by a seeded
    rng) and insert 10 bytes at offset 4,096 of one binary."""
    rng = np.random.default_rng(seed)
    texts, bins = [], []
    for dirpath, _, names in os.walk(ctx):
        for name in names:
            path = os.path.join(dirpath, name)
            (texts if name.endswith(".js") else
             bins if name.endswith(".bin") else []).append(path)
    texts.sort()
    bins.sort()
    picked = rng.choice(len(texts), size=max(1, len(texts) // 100),
                        replace=False)
    for i in sorted(picked.tolist()):
        with open(texts[i], "ab") as f:
            f.write(b"/* edit 000001 */"[:16])
    binary = bins[int(rng.integers(0, len(bins)))]
    with open(binary, "rb") as f:
        data = f.read()
    with open(binary, "wb") as f:
        f.write(data[:4096] + b"0123456789" + data[4096:])
    return {"text_files": len(texts), "edited_text_files": len(picked),
            "binary": os.path.relpath(binary, ctx)}


def check_launches(build: dict, rows: list[dict], ring_bytes: int) -> None:
    """G1 once per 4 MiB block and S1 once per ring pass of each
    committed layer, as the sessions counted them."""
    recs = commits(build)
    blocks = sum(r["gear_blocks"] for r in recs)
    passes = sum(-(-row["bytes"] // ring_bytes) for row in rows)
    check(len(recs) == len(rows), f"{len(recs)} layers committed, "
          f"{len(rows)} with cache entries")
    check(build["launches"]["gear_bitmap"] == blocks
          == sum(-(-row["bytes"] // (4 * MIB)) for row in rows),
          f"gear launches {build['launches']} != 4 MiB blocks {blocks}")
    check(build["launches"]["sha256_spans"] == passes
          == sum(r["span_launches"] for r in recs),
          f"sha256 launches {build['launches']} != ring passes {passes}")


def hits(build: dict) -> list[str]:
    return [r["msg"] for r in build["records"]
            if r["msg"].startswith("cache hit ") and " -> " in r["msg"]]


def no_launches(build: dict) -> bool:
    return build["launches"] == {"gear_bitmap": 0, "sha256_spans": 0}


def config3_builds(torch, np, dev, work: str, ring_bytes: int,
                   tel: str) -> dict:
    """(a) the cold build of a LOCAL_BYTES config-3 app, indexed; (b) its warm
    rebuild on the blob route; (c) its rebuild on the chunk route, the
    blob deleted. (a) and (b) write every telemetry artifact into
    ``tel`` (phase 10 reads them)."""
    ctx = os.path.join(work, "local")
    os.makedirs(ctx)
    t0 = time.perf_counter()
    nfiles, nbytes = write_context(np, ctx, LOCAL_BYTES)
    with open(os.path.join(ctx, "Dockerfile"), "w") as f:
        f.write(CONFIG3_DOCKERFILE)
    write_s = time.perf_counter() - t0
    storage = os.path.join(work, "storage")
    chunk_root = os.path.join(storage, "chunks")
    dest = os.path.join(work, "image.tar")
    tag = "smoke/config3:1"

    # (a) cold, with --dest.
    cold = run_build(storage, os.path.join(work, "root1"), ctx, tag,
                     os.path.join(work, "cold.log"), "--dest", dest,
                     telemetry=telemetry_flags(tel, "a"))
    from makisu_tpu_torch.utils import metrics
    overhead = metrics.global_registry().gauge_value(
        metrics.PROFILER_OVERHEAD)
    t0 = time.perf_counter()
    rows = check_committed_layers(torch, np, dev, storage)
    check_s = time.perf_counter() - t0
    layers, diff_ids = image_layers(storage, tag)
    check(len(rows) == len(layers) == 1
          and layers[0]["digest"] == rows[0]["gzip"]
          and diff_ids == [rows[0]["tar"]],
          f"config-3 image layers {layers} differ from the committed "
          f"layer {rows}")
    check_launches(cold, rows, ring_bytes)
    check_native_sink(cold)
    cold_tally = stat_tally(cold)
    check(cold_tally["hits"] == 0 and cold_tally["misses_by_reason"]
          == {"absent": nfiles + 1} == {"absent": cold_tally["files"]},
          f"cold stat-cache tally {cold_tally} for {nfiles + 1} files")
    with tarfile.open(dest) as tf:
        [export] = json.load(tf.extractfile("manifest.json"))
        check(export["RepoTags"] == [tag]
              and [tf.getmember(n).size for n in export["Layers"]]
              == [rows[0]["bytes"]], "the --dest tar's layers differ")
    os.unlink(dest)
    [rec] = commits(cold)
    chunk_list = kv_layers(storage)[rows[0]["gzip"]]["chunks"]
    lengths = {h: n for _, n, h in chunk_list}
    t0 = time.perf_counter()
    cas = check_chunk_cas(chunk_root, set(lengths))
    cas_check_s = time.perf_counter() - t0
    idx = indexed(cold)
    # A cold index adds every distinct digest; bytes_reused counts the
    # layer's own repeats (the reference's accounting), none from before.
    check(idx["added"] == len(lengths) == cas["files"]
          and idx["chunks"] == len(chunk_list)
          and idx["bytes_added"] == sum(lengths.values()) == cas["bytes"]
          and idx["bytes_reused"] == idx["bytes_total"] - idx["bytes_added"]
          and idx["bytes_total"] == rows[0]["bytes"],
          f"cold index {idx} against {len(lengths)} distinct chunks, "
          f"CAS {cas}")

    # (b) warm: the blob route; the stat cache (default racy window)
    # spares every file hashed 2 s or more after its last change.
    cached, trusted = trusted_entries(storage, ctx)
    warm = run_build(storage, os.path.join(work, "root2"), ctx, tag,
                     os.path.join(work, "warm.log"),
                     telemetry=telemetry_flags(tel, "b"))
    warm_tally = stat_tally(warm)
    check(cached == warm_tally["files"] == nfiles + 1
          and warm_tally["hits"] == trusted
          and warm_tally["misses_by_reason"]
          == ({"racy": cached - trusted} if cached > trusted else {}),
          f"warm stat-cache tally {warm_tally}: {cached} cached entries, "
          f"{trusted} outside the racy window")
    warm_hits = hits(warm)
    check(not commits(warm) and len(warm_hits) == 1
          and "(lazy: " not in warm_hits[0] and no_launches(warm)
          and image_layers(storage, tag) == (layers, diff_ids),
          f"warm rebuild: {len(commits(warm))} layers committed, hits "
          f"{warm_hits}, launches {warm['launches']}")
    cold_tel = check_cold_telemetry(tel, cold, rows, chunk_list,
                                    overhead)
    warm_tel = check_warm_telemetry(tel, warm)

    # (c) the blob deleted: the chunk route, then --dest.
    blob_hex = rows[0]["gzip"].split(":")[1]
    blob_path = os.path.join(storage, "layers", blob_hex[:2], blob_hex)
    want_blob = sha256_file(blob_path)
    check(want_blob == (blob_hex, rows[0]["gzip_bytes"]),
          "the layer blob differs from its digest")
    os.unlink(blob_path)
    dest2 = os.path.join(work, "image2.tar")
    lazy = run_build(storage, os.path.join(work, "root3"), ctx, tag,
                     os.path.join(work, "lazy.log"), "--dest", dest2)
    lazy_hits = hits(lazy)
    applied = [r["msg"] for r in lazy["records"]
               if r["msg"].startswith("applying layer ")]
    check(not commits(lazy) and len(lazy_hits) == 1
          and lazy_hits[0].endswith(
              f"(lazy: {len(chunk_list)} chunks available)")
          and applied == [f"applying layer {blob_hex} from "
                          f"{len(chunk_list)} chunks (no blob, no gzip)"]
          and no_launches(lazy)
          and image_layers(storage, tag) == (layers, diff_ids),
          f"chunk-route rebuild: {len(commits(lazy))} layers committed, "
          f"hits {lazy_hits}, {applied}, launches {lazy['launches']}")
    got_blob = sha256_file(blob_path)
    check(got_blob == want_blob, f"the reconstituted blob {got_blob} "
          f"differs from the deleted one {want_blob}")
    with tarfile.open(dest2) as tf:
        [export] = json.load(tf.extractfile("manifest.json"))
        h = hashlib.sha256()
        with tf.extractfile(export["Layers"][0]) as f:
            while piece := f.read(16 * MIB):
                h.update(piece)
        check(len(export["Layers"]) == 1
              and "sha256:" + h.hexdigest() == diff_ids[0]
              and tf.getmember(export["Layers"][0]).size
              == rows[0]["bytes"], "the --dest tar's layer differs from "
              "the layer tar")
    os.unlink(dest2)
    check(os.listdir(os.path.join(chunk_root, "_tmp")) == [],
          "reconstitution left a temp file behind")
    return {
        "config3": {"files": nfiles, "file_bytes": nbytes,
                    "write_context_s": write_s,
                    "build_wall_s": cold["wall_s"],
                    **cold["phases"],
                    "sink": rec["sink"],
                    "commit_wall_s": rec["commit_s"],
                    "sync_s": rec["sync_s"],
                    "diff_s": rec["diff_s"],
                    "compress_s": rec["compress_s"],
                    "session_s": rec["session_s"],
                    "session_wait_s": rec["session_wait_s"],
                    "bytes": rows[0]["bytes"],
                    "gzip_bytes": rows[0]["gzip_bytes"],
                    "chunks": rows[0]["chunks"],
                    "distinct_chunks": rows[0]["distinct_chunks"],
                    "ring_passes": rec["span_launches"],
                    "launches": cold["launches"],
                    "indexed": idx, "chunk_cas": cas,
                    "check_s": check_s, "cas_check_s": cas_check_s,
                    "telemetry": cold_tel},
        "warm": {"wall_s": warm["wall_s"], **warm["phases"],
                 "cache_hits": len(warm_hits),
                 "stat_cache": warm_tally,
                 "launches": warm["launches"],
                 "telemetry": warm_tel},
        "chunk_route": {"wall_s": lazy["wall_s"], **lazy["phases"],
                        "cache_hits": len(lazy_hits),
                        "chunks": len(chunk_list),
                        "blob_bytes": got_blob[1],
                        "launches": lazy["launches"]},
    }


def edit_builds(torch, np, dev, work: str, ring_bytes: int) -> dict:
    """(d) a 64 MiB app built cold, edited, and rebuilt: the rebuild
    indexes exactly the new layer's digests that the old one lacks."""
    ctx = os.path.join(work, "edit")
    os.makedirs(ctx)
    nfiles, nbytes = write_context(np, ctx, EDIT_BYTES, seed=7)
    with open(os.path.join(ctx, "Dockerfile"), "w") as f:
        f.write(CONFIG3_DOCKERFILE)
    storage = os.path.join(work, "edit-storage")
    chunk_root = os.path.join(storage, "chunks")
    tag = "smoke/edit:1"
    v1 = run_build(storage, os.path.join(work, "root4"), ctx, tag,
                   os.path.join(work, "edit1.log"))
    [v1_digest] = committed_digests(v1)
    v1_chunks = {h for _, _, h in kv_layers(storage)[v1_digest]["chunks"]}
    before = cas_names(chunk_root)
    check(before == v1_chunks, "the v1 index differs from its chunks")
    edits = edit_context(np, ctx, seed=17)
    v2 = run_build(storage, os.path.join(work, "root5"), ctx, tag,
                   os.path.join(work, "edit2.log"))
    v2_digests = committed_digests(v2)
    check(len(v2_digests) == 1 and not hits(v2) and v2_digests
          != {v1_digest}, f"edit rebuild: committed {v2_digests}, hits "
          f"{hits(v2)}")
    rows = check_committed_layers(torch, np, dev, storage, v2_digests)
    check_launches(v2, rows, ring_bytes)
    v2_chunks = {h for _, _, h in
                 kv_layers(storage)[rows[0]["gzip"]]["chunks"]}
    new = cas_names(chunk_root) - before
    idx = indexed(v2)
    check(new == v2_chunks - v1_chunks and idx["added"] == len(new)
          and idx["bytes_total"] == rows[0]["bytes"]
          and idx["bytes_added"] <= 0.05 * idx["bytes_total"],
          f"edit index {idx}: {len(new)} new CAS files, "
          f"{len(v2_chunks - v1_chunks)} digests absent from v1")
    [rec] = commits(v2)
    return {"files": nfiles, "file_bytes": nbytes, **edits,
            "v1_wall_s": v1["wall_s"], "v1_index_s": v1["phases"]["index_s"],
            "wall_s": v2["wall_s"], **v2["phases"],
            "commit_wall_s": rec["commit_s"],
            "bytes": rows[0]["bytes"], "chunks": rows[0]["chunks"],
            "indexed": idx,
            "bytes_added_share": idx["bytes_added"] / idx["bytes_total"],
            "launches": v2["launches"]}


def small_build(torch, np, dev, work: str, ring_bytes: int) -> dict:
    """(e) a small two-stage build with RUN steps (--modifyfs, --commit
    explicit), under ``--torch-profile``: its Chrome trace holds every
    G1 and S1 launch of the build."""
    small_ctx = os.path.join(work, "small")
    os.makedirs(small_ctx)
    small_files, _ = write_context(np, small_ctx, 4 * MIB, seed=5)
    with open(os.path.join(small_ctx, "Dockerfile"), "w") as f:
        f.write(SMALL_DOCKERFILE)
    small_storage = os.path.join(work, "small-storage")
    prof_dir = os.path.join(work, "small-profile")
    small = run_build(small_storage, os.path.join(work, "root6"),
                      small_ctx, "smoke/small:1",
                      os.path.join(work, "small.log"), "--modifyfs",
                      "--commit", "explicit", "--gzip-backend", "auto",
                      telemetry=("--torch-profile", prof_dir))
    [prof_path] = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir)]
    with open(prof_path) as f:
        kernel_names = [e["name"] for e in json.load(f)["traceEvents"]
                        if e.get("ph") == "X" and e.get("cat") == "kernel"]
    profiled = {"gear_bitmap": sum("gear_bitmap_kernel" in n
                                   for n in kernel_names),
                "sha256_spans": sum("sha256_spans_kernel" in n
                                    for n in kernel_names)}
    check(profiled == small["launches"] and min(profiled.values()) > 0,
          f"--torch-profile trace holds {profiled} kernels, the build "
          f"launched {small['launches']}")
    small_rows = check_committed_layers(torch, np, dev, small_storage)
    check(len(small_rows) == 2, f"small build committed {small_rows}")
    gz_ids = {e["gz"] for e in kv_layers(small_storage).values()}
    check(gz_ids == {PGZIP_ID}, f"--gzip-backend auto wrote {gz_ids}, not "
          f"{PGZIP_ID} (the native codec loads here)")
    check_launches(small, small_rows, ring_bytes)
    small_layers, _ = image_layers(small_storage, "smoke/small:1")
    check(len(small_layers) == 1 and small_layers[0]["digest"]
          in {row["gzip"] for row in small_rows},
          f"the small image's layers {small_layers} are not its final "
          "stage's commit")
    return {"files": small_files, "wall_s": small["wall_s"],
            "gz": sorted(gz_ids), "launches": small["launches"],
            "torch_profile_kernels": profiled,
            "torch_profile_bytes": os.path.getsize(prof_path),
            "layers": [{"bytes": row["bytes"], "chunks": row["chunks"],
                        "session_s": r["session_s"],
                        "commit_s": r["commit_s"]}
                       for row, r in zip(small_rows, commits(small))]}


def build_phase(torch, np, dev, work: str, tel: str) -> dict:
    """(a)-(c) the config-3 builds at LOCAL_BYTES, (d) the edit rebuild, (e)
    the small two-stage build."""
    import shutil

    from makisu_tpu_torch.chunker.cdc import BLOCK, ChunkSession

    ring_bytes = ChunkSession.RING_BLOCKS * BLOCK
    out = {"phase": "build",
           **config3_builds(torch, np, dev, work, ring_bytes, tel)}
    for name in ("local", "storage"):
        shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    out["edit"] = edit_builds(torch, np, dev, work, ring_bytes)
    out["small"] = small_build(torch, np, dev, work, ring_bytes)
    return out


# -- phase 8: the registry plane ---------------------------------------------

BASE_BYTES = 16 * MIB
PGZIP_ID = "pgzip-6-131072"


def first_ts(build: dict, prefix: str) -> float | None:
    return next((r["ts"] for r in build["records"]
                 if r["msg"].startswith(prefix)), None)


def record(build: dict, prefix: str, contains: str = "") -> dict:
    [rec] = [r for r in build["records"]
             if r["msg"].startswith(prefix) and contains in r["msg"]]
    return rec


def registry_manifest(reg, repo: str, tag: str) -> dict:
    _, raw = reg.state.repos[repo].manifests[tag]
    return json.loads(raw)


def local_manifest(storage: str, repo: str, tag: str) -> dict:
    with open(os.path.join(storage, "manifests", repo, tag + ".json")) as f:
        return json.load(f)


def check_registry_blobs(reg, repo: str, manifest: dict) -> int:
    """Every blob of ``manifest`` is in the registry's repository with a
    sha256 equal to its digest and its recorded size; returns the bytes."""
    blobs = reg.state.repos[repo].blobs
    total = 0
    for desc in [manifest["config"], *manifest["layers"]]:
        data = blobs.get(desc["digest"])
        check(data is not None and len(data) == desc["size"]
              and "sha256:" + hashlib.sha256(data).hexdigest()
              == desc["digest"], f"registry blob {desc['digest']} of "
              f"{repo} is missing or differs from its digest")
        total += len(data)
    return total


def check_pgzip_blob(storage: str, row: dict) -> float:
    """The layer blob is pgzip (its block-format header) and the port's
    own ``gzip_writer`` reproduces it from the tar; returns the seconds
    the rewrite took."""
    from makisu_tpu_torch import tario

    hexd = row["gzip"].split(":")[1]
    with open(os.path.join(storage, "layers", hexd[:2], hexd), "rb") as f:
        blob = f.read()
    check(blob[:10] == tario._PGZIP_HEADER, f"layer {hexd} is not pgzip")
    tar = gzip.decompress(blob)
    out = tario.TeeDigest(io.BytesIO())
    t0 = time.perf_counter()
    with tario.gzip_writer(out, backend_id=PGZIP_ID) as gz:
        for i in range(0, len(tar), 16 * MIB):
            gz.write(tar[i:i + 16 * MIB])
    seconds = time.perf_counter() - t0
    check(out.digest.hexdigest() == hexd and out.size == len(blob),
          f"the port's pgzip writer does not reproduce layer {hexd}")
    return seconds


def check_packs(reg, repo: str, entry: dict) -> dict:
    """The entry's packs are in the registry, each the concatenation of
    its members' chunk bytes, their members exactly the layer's distinct
    chunk digests, and a pin manifest tags every pack."""
    from makisu_tpu_torch.cache.chunks import PACK_MEDIA_TYPE

    blobs = reg.state.repos[repo].blobs
    chunks = entry["chunks"]
    packs = entry.get("packs") or []
    check(packs, "set_entry_packs wrote no packs onto the KV entry")
    members = []
    pack_bytes = 0
    for pack_hex, idx in packs:
        data = blobs.get("sha256:" + pack_hex)
        check(data is not None
              and hashlib.sha256(data).hexdigest() == pack_hex
              and len(data) == sum(chunks[i][1] for i in idx),
              f"pack {pack_hex} missing from the registry or wrong")
        pos = 0
        for i in idx:
            _, n, h = chunks[i]
            check(hashlib.sha256(data[pos:pos + n]).hexdigest() == h,
                  f"pack {pack_hex}: member {i} differs from chunk {h}")
            pos += n
        members += [chunks[i][2] for i in idx]
        pack_bytes += len(data)
    distinct = {h for _, _, h in chunks}
    check(len(members) == len(set(members)) and set(members) == distinct,
          f"pack members ({len(members)}) differ from the layer's "
          f"{len(distinct)} distinct chunks")
    layer_hex = entry["gzip"].split(":")[1]
    repo_state = reg.state.repos[repo]
    pins = sorted(t for t in repo_state.tags
                  if t.startswith(f"makisu-packs-{layer_hex[:40]}"))
    pinned = set()
    for tag in pins:
        doc = json.loads(repo_state.manifests[tag][1])
        check({d["mediaType"] for d in doc["layers"]} == {PACK_MEDIA_TYPE},
              f"pin manifest {tag} has non-pack layers")
        pinned |= {d["digest"].split(":")[1] for d in doc["layers"]}
    check(pinned == {p for p, _ in packs},
          f"pin manifests {pins} do not pin exactly the {len(packs)} packs")
    return {"packs": len(packs), "pack_bytes": pack_bytes,
            "pack_members": len(members), "pin_manifests": len(pins)}


def blob_requests(reg, repo: str, verb: str) -> list[str]:
    return [path for v, path, _ in reg.state.requests
            if v == verb and path.startswith(f"/v2/{repo}/blobs/sha256:")]


def registry_phase(torch, np, dev, work: str) -> dict:
    """(f) a 16 MiB base pushed with pgzip; (g) the config-3 app built FROM
    it, committed with pgzip and pushed with its chunk packs; (h) the app
    pulled into a fresh storage; (i) the app rebuilt into a fresh storage
    seeded with (g)'s KV file alone, its layer blob gone from the
    registry: the chunk route from registry packs, and the blob
    reconstituted for the push and ``--dest``. One JSON line per step."""
    import shutil

    from makisu_tpu_torch import cli
    from makisu_tpu_torch.chunker.cdc import BLOCK, ChunkSession
    from makisu_tpu_torch.tools.miniregistry import MiniRegistry
    from makisu_tpu_torch.utils import concurrency

    ring_bytes = ChunkSession.RING_BLOCKS * BLOCK
    reg = MiniRegistry().start()  # 127.0.0.1, an ephemeral port
    try:
        out = {"phase": "registry", "registry": reg.addr,
               "compress_workers": concurrency.compress_workers()}
        push = ("--gzip-backend", "pgzip", "--push", reg.addr)
        # The config-3 context of (g) and (i).
        ctx3 = os.path.join(work, "config3")
        os.makedirs(ctx3)
        t0 = time.perf_counter()
        files3, bytes3 = write_context(np, ctx3, REGISTRY_BYTES)
        with open(os.path.join(ctx3, "Dockerfile"), "w") as f:
            f.write(CONFIG3_DOCKERFILE)
        write3_s = time.perf_counter() - t0

        # (f) the base.
        base_ctx = os.path.join(work, "base")
        os.makedirs(base_ctx)
        base_files, base_bytes = write_context(np, base_ctx, BASE_BYTES,
                                               seed=13)
        with open(os.path.join(base_ctx, "Dockerfile"), "w") as f:
            f.write("FROM scratch\nCOPY . /base/\nENV BASE=smoke\n")
        base_storage = os.path.join(work, "base-storage")
        base = run_build(base_storage, os.path.join(work, "root7"),
                         base_ctx, "smoke/base:1",
                         os.path.join(work, "base.log"), *push)
        base_rows = check_committed_layers(torch, np, dev, base_storage)
        check(len(base_rows) == 1, f"base committed {base_rows}")
        check_launches(base, base_rows, ring_bytes)
        base_manifest = local_manifest(base_storage, "smoke/base", "1")
        check(registry_manifest(reg, "smoke/base", "1") == base_manifest,
              "the registry's base manifest differs from the local one")
        check_registry_blobs(reg, "smoke/base", base_manifest)
        out["base"] = {"files": base_files, "file_bytes": base_bytes,
                       "wall_s": base["wall_s"],
                       "bytes": base_rows[0]["bytes"],
                       "gzip_bytes": base_rows[0]["gzip_bytes"],
                       "launches": base["launches"]}
        emit({"phase": "registry", "step": "f_base", **out["base"]})

        # (g) the app FROM the base, at full size, into a fresh storage.
        dockerfile = os.path.join(work, "app.Dockerfile")
        with open(dockerfile, "w") as f:
            f.write(f"FROM {reg.addr}/smoke/base:1\n" + CONFIG3_DOCKERFILE
                    .split("\n", 1)[1])
        storage = os.path.join(work, "app-storage")
        bytes_in = reg.state.blob_bytes_in
        app = run_build(storage, os.path.join(work, "root8"), ctx3,
                        "smoke/app:1", os.path.join(work, "app.log"),
                        "-f", dockerfile, *push)
        pushed_bytes = reg.state.blob_bytes_in - bytes_in
        base_layer = base_manifest["layers"][0]["digest"]
        check(f"/v2/smoke/base/blobs/{base_layer}"
              in blob_requests(reg, "smoke/base", "GET")
              and first_ts(app, f"applying FROM layer "
                           f"{base_layer.split(':')[1]}") is not None,
              "the base layer was not pulled from the registry and applied")
        [app_digest] = committed_digests(app)
        rows = check_committed_layers(torch, np, dev, storage, {app_digest})
        check_launches(app, rows, ring_bytes)
        check_native_sink(app)
        [rec] = commits(app)
        check(rec.get("compress_workers") == concurrency.compress_workers(),
              "the commit line's compress_workers "
              f"{rec.get('compress_workers')}")
        rewrite_s = check_pgzip_blob(storage, rows[0])
        entry = kv_layers(storage)[app_digest]
        check(entry["gz"] == PGZIP_ID, f"the entry's gz is {entry['gz']}")
        app_manifest = local_manifest(storage, "smoke/app", "1")
        check(registry_manifest(reg, "smoke/app", "1") == app_manifest,
              "the registry's app manifest differs from the local one")
        blob_bytes = check_registry_blobs(reg, "smoke/app", app_manifest)
        packs = check_packs(reg, "smoke/app", entry)
        pushed_rec = record(app, "pushed ", " pack blob(s) for ")
        t_built = first_ts(app, "successfully built image")
        t_indexed = record(app, "indexed ")["ts"]
        out["app"] = {
            "files": files3, "file_bytes": bytes3,
            "write_context_s": write3_s,
            "wall_s": app["wall_s"], **app["phases"],
            "sink": rec["sink"], "diff_s": rec["diff_s"],
            "commit_s": rec["commit_s"], "compress_s": rec["compress_s"],
            "compress_workers": rec["compress_workers"],
            "session_s": rec["session_s"],
            "bytes": rows[0]["bytes"], "gzip_bytes": rows[0]["gzip_bytes"],
            "chunks": rows[0]["chunks"],
            "distinct_chunks": rows[0]["distinct_chunks"],
            "launches": app["launches"],
            # The layer blob and the packs upload on the cache's push
            # threads; after its index the build waits for them, then
            # pushes the image, whose blobs HEAD-skip.
            "push_wait_s": t_built - t_indexed,
            "pack_push_s": pushed_rec["ts"] - t_indexed,
            "image_push_s": first_ts(app, "successfully pushed ") - t_built,
            "pushed_blob_bytes": blob_bytes,
            "pushed_bytes": pushed_bytes, **packs,
            "pgzip_rewrite_s": rewrite_s}
        emit({"phase": "registry", "step": "g_app", **out["app"]})

        # (h) pull into a fresh storage.
        pull_storage = os.path.join(work, "pull-storage")
        log = os.path.join(work, "pull.log")
        t0 = time.perf_counter()
        rc = cli.main(["--log-fmt", "json", "--log-output", log, "pull",
                       f"{reg.addr}/smoke/app:1", "--storage",
                       pull_storage])
        pull_s = time.perf_counter() - t0
        check(rc == 0, f"pull exited {rc}")
        check(local_manifest(pull_storage, "smoke/app", "1") == app_manifest,
              "the pulled manifest differs from (g)'s")
        for desc in [app_manifest["config"], *app_manifest["layers"]]:
            hexd = desc["digest"].split(":")[1]
            got = sha256_file(os.path.join(pull_storage, "layers",
                                           hexd[:2], hexd))
            want = sha256_file(os.path.join(storage, "layers", hexd[:2],
                                            hexd))
            check(got == want == (hexd, desc["size"]),
                  f"pulled blob {hexd} differs from (g)'s")
        out["pull"] = {"pull_s": pull_s,
                       "bytes": sum(d["size"] for d in app_manifest["layers"])}
        emit({"phase": "registry", "step": "h_pull", **out["pull"]})
        shutil.rmtree(pull_storage, ignore_errors=True)

        # (i) the remote chunk route: a fresh storage with (g)'s KV file
        # only, the app layer's blob removed from the registry.
        app_hex = app_digest.split(":")[1]
        blob_path = os.path.join(storage, "layers", app_hex[:2], app_hex)
        want_blob = sha256_file(blob_path)
        remote_storage = os.path.join(work, "remote-storage")
        os.makedirs(remote_storage)
        shutil.copy(os.path.join(storage, "cache_key_value.json"),
                    remote_storage)
        shutil.rmtree(storage, ignore_errors=True)
        with reg.state.lock:
            del reg.state.repos["smoke/app"].blobs[app_digest]
        dest = os.path.join(work, "remote.tar")
        remote = run_build(remote_storage, os.path.join(work, "root9"),
                           ctx3, "smoke/app:1",
                           os.path.join(work, "remote.log"), "-f",
                           dockerfile, *push, "--dest", dest)
        chunk_list = entry["chunks"]
        remote_hits = hits(remote)
        applied = [r["msg"] for r in remote["records"]
                   if r["msg"].startswith("applying layer ")]
        fetched = record(remote, "fetched ")
        check(not commits(remote) and len(remote_hits) == 1
              and remote_hits[0].endswith(
                  f"(lazy: {len(chunk_list)} chunks available)")
              and applied == [f"applying layer {app_hex} from "
                              f"{len(chunk_list)} chunks (no blob, no gzip)"]
              and no_launches(remote),
              f"remote chunk route: {len(commits(remote))} layers "
              f"committed, hits {remote_hits}, {applied}, launches "
              f"{remote['launches']}")
        check(fetched["msg"].startswith(
            f"fetched {packs['pack_members']}/{packs['pack_members']} "
            f"missing chunks from {packs['packs']} pack(s)"),
            f"pack fetch: {fetched['msg']}")
        got_blob = sha256_file(os.path.join(remote_storage, "layers",
                                            app_hex[:2], app_hex))
        check(got_blob == want_blob, f"the reconstituted blob {got_blob} "
              f"differs from (g)'s {want_blob}")
        again = reg.state.repos["smoke/app"].blobs.get(app_digest)
        check(again is not None
              and hashlib.sha256(again).hexdigest() == app_hex,
              "the reconstituted blob was not pushed again")
        with tarfile.open(dest) as tf:
            [export] = json.load(tf.extractfile("manifest.json"))
            check(len(export["Layers"]) == 2
                  and tf.getmember(export["Layers"][1]).size
                  == rows[0]["bytes"], "the --dest tar's layers differ")
        os.unlink(dest)
        recon = record(remote, "reconstituted layer ")
        out["remote"] = {
            "wall_s": remote["wall_s"], **remote["phases"],
            "pack_fetch_s": fetched["seconds"],
            "pack_fetch_bytes": fetched["bytes"],
            "reconstitute_s": recon["seconds"],
            "image_push_s": first_ts(remote, "successfully pushed ")
            - first_ts(remote, "successfully built image"),
            "cache_hits": len(remote_hits), "chunks": len(chunk_list),
            "blob_bytes": got_blob[1], "launches": remote["launches"]}
        emit({"phase": "registry", "step": "i_remote_chunk_route",
              **out["remote"]})
        return out
    finally:
        reg.stop()


# -- phase 9: resident build sessions ----------------------------------------

SESSION_SHARDS = 8
WATCH_BYTES = 16 * MIB
EDIT_TAIL = b"/* edit 000001 */"[:16]
# The session's line of each build (the identity before ": mode=").
MODE_LINE = re.compile(r"build session \S+: mode=(\w+) dirty=(\d+)")


def sharded_dockerfile(shards: int) -> str:
    return "FROM scratch\n" + "".join(
        f"COPY shard{k}/ /app/shard{k}/\n" for k in range(shards))


def append_edits(np, shard_dir: str, count: int, seed: int) -> list[str]:
    """Append 16 bytes to ``count`` text files of ``shard_dir`` chosen by
    a seeded rng; returns their paths."""
    texts = sorted(os.path.join(d, n) for d, _, names in os.walk(shard_dir)
                   for n in names if n.endswith(".js"))
    rng = np.random.default_rng(seed)
    picked = [texts[i] for i in sorted(
        rng.choice(len(texts), size=count, replace=False).tolist())]
    for path in picked:
        with open(path, "ab") as f:
            f.write(EDIT_TAIL)
    return picked


def session_build(torch, dev, storage: str, root: str, ctx: str, tag: str,
                  log: str, mgr) -> dict:
    """``run_build`` on the resident manager ``mgr``, with what phase 9
    reads of the build: its warm mode and dirty count, the stat-cache
    tallies of its COPY steps, its cached layers replayed and inflated,
    and the card's allocated bytes after it."""
    b = run_build(storage, root, ctx, tag, log, manager=mgr)
    [line] = [r for r in b["records"] if MODE_LINE.match(r["msg"])]
    mode, dirty = MODE_LINE.match(line["msg"]).groups()
    msgs = [r["msg"] for r in b["records"]]
    tallies = [r for r in b["records"]
               if r["msg"].startswith("stat cache for ")]
    recs = commits(b)
    b.update(
        mode=mode, dirty=int(dirty), watcher=line.get("watcher"),
        tallies=tallies,
        replayed=sum(m.startswith("replaying resident layer ")
                     for m in msgs),
        inflated=sum(m.startswith("applying cached layer ") for m in msgs),
        device_bytes=torch.cuda.memory_allocated(dev))
    b["row"] = {
        "wall_s": b["wall_s"], "plan_s": b["phases"]["plan_s"],
        "mode": mode, "dirty": int(dirty), "watcher": b["watcher"],
        "files_read": sum(t["misses"] for t in tallies),
        "bytes_read": sum(t["bytes_rehashed"] for t in tallies),
        "memo_sources": sum(t["memo_sources"] for t in tallies),
        "layers_replayed": b["replayed"], "layers_inflated": b["inflated"],
        "layers_committed": len(recs),
        "commit_wall_s": recs[0]["commit_s"] if recs else None,
        "session_s": recs[0]["session_s"] if recs else None,
        "index_s": b["phases"].get("index_s"),
        "launches": b["launches"], "device_bytes": b["device_bytes"]}
    if b["device_bytes"]:
        b["row"]["device_holders"] = device_holders(torch, dev)
    return b


def device_holders(torch, dev) -> dict:
    """What may hold the card's bytes after a build: the bytes still
    allocated after a full collection, and each live ``ChunkSession``
    (ring held or dropped, blocks scanned, S1 launches, results not yet
    drained)."""
    import gc

    from makisu_tpu_torch.chunker.cdc import ChunkSession

    gc.collect()
    return {"after_gc": torch.cuda.memory_allocated(dev),
            "sessions": [{"ring": s._ring is not None, "blocks": s.blocks,
                          "span_launches": s.span_launches,
                          "pending": len(s._pending)}
                         for s in gc.get_objects()
                         if type(s) is ChunkSession]}


def timeless_config(storage: str, tag: str) -> dict:
    """The image's config without its wall-clock stamps."""
    repo, _, name = tag.rpartition(":")
    manifest = local_manifest(storage, repo, name)
    cfg = manifest["config"]["digest"].split(":")[1]
    with open(os.path.join(storage, "layers", cfg[:2], cfg), "rb") as f:
        config = json.load(f)
    config.pop("created", None)
    for h in config.get("history", []):
        h.pop("created", None)
    return config


def sessionless_build(storage: str, root: str, ctx: str, tag: str,
                      log: str) -> dict:
    """``run_build`` with MAKISU_TPU_SESSION=0: the oracle of a
    resident build."""
    before = os.environ.get("MAKISU_TPU_SESSION")
    os.environ["MAKISU_TPU_SESSION"] = "0"
    try:
        return run_build(storage, root, ctx, tag, log)
    finally:
        if before is None:
            os.environ.pop("MAKISU_TPU_SESSION")
        else:
            os.environ["MAKISU_TPU_SESSION"] = before


def check_same_image(storage: str, other: str, tag: str) -> None:
    """Two storages hold ``tag`` with the same layers, diff_ids and
    config but for its wall-clock stamps (so the manifest differs in the
    config digest alone)."""
    check(image_layers(storage, tag) == image_layers(other, tag)
          and timeless_config(storage, tag) == timeless_config(other, tag),
          f"{tag}: the resident build's image differs from the "
          "session-less one")


def edit_rebuild(torch, np, dev, ctx: str, storage: str, work: str,
                 mgr, ring_bytes: int, step: str, count: int, seed: int,
                 cold_layers: list) -> dict:
    """An edit of ``count`` text files of the last shard, the resident
    rebuild, and the session-less oracle of the same tree built into a
    copy of the storage taken before the rebuild."""
    edited = append_edits(np, os.path.join(
        ctx, f"shard{SESSION_SHARDS - 1}"), count, seed)
    copy = os.path.join(work, f"oracle-{step}")
    t0 = time.perf_counter()
    # The chunk CAS and the snapshot plane stay out of the copy: the
    # oracle's index adds its chunks afresh, and it has no session.
    shutil.copytree(storage, copy,
                    ignore=shutil.ignore_patterns("chunks", "serve"))
    copy_s = time.perf_counter() - t0
    tag = f"smoke/session:{step}"
    b = session_build(torch, dev, storage, os.path.join(work, "sroot"),
                      ctx, tag, os.path.join(work, f"session-{step}.log"),
                      mgr)
    tallies = b["tallies"]
    check(b["mode"] == "resident" and b["dirty"] == count
          and b["replayed"] == SESSION_SHARDS - 1 and b["inflated"] == 0
          and [t["memo_sources"] for t in tallies]
          == [1] * (SESSION_SHARDS - 1) + [0]
          and [t["misses"] for t in tallies]
          == [0] * (SESSION_SHARDS - 1) + [count],
          f"{step}: mode {b['mode']}, dirty {b['dirty']}, replayed "
          f"{b['replayed']}, inflated {b['inflated']}, tallies "
          f"{[(t['memo_sources'], t['misses']) for t in tallies]}")
    [digest] = committed_digests(b)
    rows = check_committed_layers(torch, np, dev, storage, {digest})
    check_launches(b, rows, ring_bytes)
    check_native_sink(b)
    layers, _ = image_layers(storage, tag)
    check([d["digest"] for d in layers[:-1]]
          == [d["digest"] for d in cold_layers[:-1]]
          and layers[-1]["digest"] == digest,
          f"{step}: the image's layers are not the cold ones but the last")
    oracle = sessionless_build(copy, os.path.join(work, "oroot"), ctx, tag,
                               os.path.join(work, f"session-{step}-oracle.log"))
    check(committed_digests(oracle) == {digest}
          and kv_layers(copy)[digest] == kv_layers(storage)[digest],
          f"{step}: the session-less build committed "
          f"{committed_digests(oracle)}, not {digest} with its chunks")
    check_same_image(storage, copy, tag)
    shutil.rmtree(copy)
    return {**b["row"], "edited_files": len(edited),
            "bytes": rows[0]["bytes"], "chunks": rows[0]["chunks"],
            "storage_copy_s": copy_s, "oracle_wall_s": oracle["wall_s"]}


def wait_for_line(proc, log: str, prefix: str, seconds: float) -> dict:
    """The first record of ``log`` starting with ``prefix``; fails when
    the process exits first or the deadline passes."""
    deadline = time.time() + seconds
    while time.time() < deadline:
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if line.endswith("\n"):
                        rec = json.loads(line)
                        if rec["msg"].startswith(prefix):
                            return rec
        check(proc.poll() is None,
              f"the --watch process exited {proc.returncode} before "
              f"{prefix!r}")
        time.sleep(0.2)
    raise RuntimeError(f"no {prefix!r} from the --watch process within "
                       f"{seconds} s")


def watch_process(np, work: str) -> dict:
    """``python -m makisu_tpu_torch.cli build --watch --hasher gpu`` on a
    16 MiB two-shard context: the initial build, one edit, rebuild #2,
    its image against a session-less build of the edited tree, then
    SIGINT and exit code 0."""
    ctx = os.path.join(work, "watch-ctx")
    os.makedirs(ctx)
    files, _ = write_context(np, ctx, WATCH_BYTES, seed=19, shards=2)
    with open(os.path.join(ctx, "Dockerfile"), "w") as f:
        f.write(sharded_dockerfile(2))
    storage = os.path.join(work, "watch-storage")
    os.makedirs(os.path.join(work, "wroot"))
    log = os.path.join(work, "watch.log")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MAKISU_TPU_STAT_CACHE_WINDOW_NS="0",
               PYTHONPATH=os.pathsep.join(
                   p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    tag = "smoke/watch:1"
    t0 = time.time()
    with open(os.path.join(work, "watch.err"), "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "makisu_tpu_torch.cli", "--log-fmt",
             "json", "--log-output", log, "build", ctx, "-t", tag,
             "--hasher", "gpu", "--storage", storage, "--root",
             os.path.join(work, "wroot"), "--watch", "--watch-interval",
             "0.2"], cwd=repo, env=env, stdout=subprocess.DEVNULL,
            stderr=err)
    try:
        first = wait_for_line(proc, log, "watch: initial build exited ",
                              300)
        check(first["msg"].startswith("watch: initial build exited 0;"),
              first["msg"])
        [edited] = append_edits(np, os.path.join(ctx, "shard1"), 1, seed=29)
        t_edit = time.time()
        rebuilt = wait_for_line(proc, log, "watch: rebuild #2 exited ", 180)
        check(rebuilt["msg"] == "watch: rebuild #2 exited 0",
              rebuilt["msg"])
        oracle_storage = os.path.join(work, "watch-oracle")
        sessionless_build(oracle_storage, os.path.join(work, "woroot"),
                          ctx, tag, os.path.join(work, "watch-oracle.log"))
        check_same_image(storage, oracle_storage, tag)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"the --watch process exited {rc} on SIGINT")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log) as f:
        records = [json.loads(line) for line in f]
    msgs = [r["msg"] for r in records]
    modes = [r for r in records if MODE_LINE.match(r["msg"])]
    probes = sum(m.startswith("sha256 parity probe passed") for m in msgs)
    # The watch loop's last line, then the command's "build telemetry".
    check(probes == 1 and len(modes) == 2
          and msgs[-2:] == ["watch: stopped after 2 builds",
                            "build telemetry"],
          f"--watch: {probes} parity probes, {len(modes)} session lines, "
          f"last lines {msgs[-2:]!r}")
    return {"files": files, "edited": os.path.relpath(edited, ctx),
            "watcher": modes[-1].get("watcher"),
            "modes": [r["mode"] for r in modes],
            "initial_build_s": first["ts"] - t0,
            "rebuild_s": rebuilt["ts"] - t_edit,
            "parity_probes": probes, "sigint_rc": rc}


def session_phase(torch, np, dev, work: str) -> dict:
    """A resident process on the card: one session manager across a
    cold build, two warm ones, a 1-file edit and a 1% edit of the last
    shard, each edit held against a session-less build of the same tree;
    then the ``--watch`` entry point as a process of its own."""
    from makisu_tpu_torch.chunker.cdc import BLOCK, ChunkSession
    from makisu_tpu_torch.worker import session

    ring_bytes = ChunkSession.RING_BLOCKS * BLOCK
    window = os.environ.get("MAKISU_TPU_STAT_CACHE_WINDOW_NS")
    os.environ["MAKISU_TPU_STAT_CACHE_WINDOW_NS"] = "0"
    try:
        ctx = os.path.join(work, "session-ctx")
        os.makedirs(ctx)
        t0 = time.perf_counter()
        files, nbytes = write_context(np, ctx, SESSION_BYTES, seed=23,
                                      shards=SESSION_SHARDS)
        with open(os.path.join(ctx, "Dockerfile"), "w") as f:
            f.write(sharded_dockerfile(SESSION_SHARDS))
        out = {"phase": "session", "files": files, "file_bytes": nbytes,
               "shards": SESSION_SHARDS,
               "write_context_s": time.perf_counter() - t0}
        storage = os.path.join(work, "session-storage")
        root = os.path.join(work, "sroot")
        mgr = session.SessionManager()
        builds = {}
        for step in ("cold", "warm_record", "warm_resident"):
            builds[step] = session_build(
                torch, dev, storage, root, ctx, f"smoke/session:{step}",
                os.path.join(work, f"session-{step}.log"), mgr)
        cold, record, resident = (builds[k] for k in builds)
        cold_layers, diff_ids = image_layers(storage, "smoke/session:cold")
        rows = check_committed_layers(torch, np, dev, storage)
        check(len(commits(cold)) == len(rows) == SESSION_SHARDS,
              f"cold: {len(commits(cold))} layers committed")
        check_launches(cold, rows, ring_bytes)
        check_native_sink(cold)
        # The first build of a session rescans; with inotify the second
        # is exact (a watcher-less host certifies from the third).
        check(cold["mode"] == "rescan" and record["inflated"]
              == SESSION_SHARDS and record["replayed"] == 0
              and not commits(record) and no_launches(record),
              f"warm (recording): mode {record['mode']}, inflated "
              f"{record['inflated']}, replayed {record['replayed']}")
        check(resident["mode"] == "resident" and resident["dirty"] == 0
              and resident["replayed"] == SESSION_SHARDS
              and resident["inflated"] == 0 and not commits(resident)
              and no_launches(resident)
              and [t["memo_sources"] for t in resident["tallies"]]
              == [1] * SESSION_SHARDS
              and resident["row"]["files_read"] == 0,
              f"resident warm build: {resident['row']}")
        for step in ("warm_record", "warm_resident"):
            check(image_layers(storage, f"smoke/session:{step}")
                  == (cold_layers, diff_ids),
                  f"{step}: the image differs from the cold one")
        shard_files = files // SESSION_SHARDS
        texts = sum(n.endswith(".js") for _, _, names in os.walk(
            os.path.join(ctx, f"shard{SESSION_SHARDS - 1}"))
            for n in names)
        edits = {
            "edit_1_file": edit_rebuild(
                torch, np, dev, ctx, storage, work, mgr, ring_bytes,
                "edit1", 1, 31, cold_layers),
            "edit_1_percent": edit_rebuild(
                torch, np, dev, ctx, storage, work, mgr, ring_bytes,
                "edit100", max(1, texts // 100), 37, cold_layers)}
        device = [b["device_bytes"] for b in builds.values()] + \
            [e["device_bytes"] for e in edits.values()]
        # No ring (or block) outlives its layer: after every build the
        # card holds less than one ring, and never more than after the
        # first build.
        check(max(device) <= device[0] and max(device) < ring_bytes,
              f"device memory after each build {device} (a ring is "
              f"{ring_bytes} bytes); what held it: "
              f"{[b['row'].get('device_holders') for b in builds.values()]}"
              f" {[e.get('device_holders') for e in edits.values()]}")
        out.update({k: b["row"] for k, b in builds.items()})
        out.update(edits)
        out.update(shard_files=shard_files, last_shard_text_files=texts,
                   device_bytes=device,
                   sessions=mgr.stats()["sessions"][0])
        mgr.reset()
        out["watch"] = watch_process(np, work)
        return out
    finally:
        if window is None:
            os.environ.pop("MAKISU_TPU_STAT_CACHE_WINDOW_NS", None)
        else:
            os.environ["MAKISU_TPU_STAT_CACHE_WINDOW_NS"] = window


# -- phase 10: the telemetry artifacts and their readers ---------------------

STALL_DOCKERFILE = """\
FROM scratch
COPY f.txt /f.txt
RUN sleep 8
"""


def telemetry_flags(tel: str, tag: str) -> tuple:
    """Every telemetry output of one build into ``tel``, the history
    file shared by the builds; a stall watchdog far above the build."""
    return ("--metrics-out", os.path.join(tel, f"R_{tag}.json"),
            "--events-out", os.path.join(tel, f"E_{tag}.jsonl"),
            "--explain-out", os.path.join(tel, f"L_{tag}.jsonl"),
            "--trace-out", os.path.join(tel, f"T_{tag}.json"),
            "--profile-out", os.path.join(tel, f"P_{tag}.json"),
            "--history-out", os.path.join(tel, "H.jsonl"),
            "--stall-timeout", "600")


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def series_sum(report: dict, kind: str, name: str, field: str = "value",
               **labels) -> float:
    return sum(s[field] for s in report[kind].get(name, [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def span_chain(report: dict, names: list[str]) -> bool:
    """Whether the span tree holds ``names`` as a parent-child chain."""
    def walk(span, rest):
        if span["name"] != rest[0]:
            return any(walk(c, rest) for c in span.get("children", []))
        if len(rest) == 1:
            return True
        return any(walk(c, rest[1:]) for c in span.get("children", []))

    return any(walk(span, names) for span in report["spans"])


def build_telemetry_line(build: dict) -> dict:
    [line] = [r for r in build["records"] if r["msg"] == "build telemetry"]
    return {k: v for k, v in line.items()
            if k not in ("level", "ts", "msg")}


def progress_gap_s(tel: str, tag: str, build: dict) -> float:
    """The longest stretch of (a) without an event or a log record: an
    upper bound on how long the build's progress clock stood still."""
    stamps = sorted([e["ts"] for e in read_jsonl(
        os.path.join(tel, f"E_{tag}.jsonl"))]
        + [r["ts"] for r in build["records"]])
    return max(b - a for a, b in zip(stamps, stamps[1:]))


def check_cold_telemetry(tel: str, cold: dict, rows: list[dict],
                         chunk_list: list, overhead: float) -> dict:
    """(a)'s report: the span chain, the gear-scan bytes against the
    layer, one dispatch observation per S1 launch, the H2D counter
    against the layer bytes, one chunk-size observation per chunk, the
    parity probe's verdict, the sampler's overhead budget."""
    from makisu_tpu_torch.utils import metrics
    with open(os.path.join(tel, "R_a.json")) as f:
        rep = json.load(f)
    check(rep["schema"] == "makisu-tpu.metrics.v1"
          and rep["exit_code"] == 0 and rep["command"] == "build",
          f"(a)'s report: schema {rep.get('schema')}, exit code "
          f"{rep.get('exit_code')}")
    check(span_chain(rep, ["build", "stage", "step", "commit_layer"]),
          "(a)'s span tree lacks build > stage > step > commit_layer")
    layer_bytes = sum(row["bytes"] for row in rows)
    gear_bytes = series_sum(rep, "counters", "makisu_gear_scan_bytes_total")
    check(gear_bytes == layer_bytes, f"gear-scan bytes {gear_bytes} != "
          f"the committed layers' tar bytes {layer_bytes}")
    launches = sum(r["span_launches"] for r in commits(cold))
    dispatches = series_sum(rep, "histograms",
                            metrics.DEVICE_DISPATCH_SECONDS, "count")
    check(dispatches == launches == cold["launches"]["sha256_spans"],
          f"{dispatches} dispatch observations, {launches} S1 launches in "
          f"the commit lines, {cold['launches']} counted")
    h2d = series_sum(rep, "counters", metrics.DEVICE_H2D_BYTES)
    session_h2d = sum(r["h2d_bytes"] for r in commits(cold))
    check(h2d == session_h2d and h2d <= 1.01 * layer_bytes,
          f"H2D counter {h2d}, sessions' h2d_bytes {session_h2d}, layer "
          f"bytes {layer_bytes}")
    sizes = series_sum(rep, "histograms", "makisu_chunk_size_bytes",
                       "count")
    check(sizes == len(chunk_list), f"{sizes} chunk-size observations, "
          f"{len(chunk_list)} chunks in the KV entry")
    probes = metrics.global_registry().report()["gauges"].get(
        "makisu_device_parity_probe_seconds", [])
    check(probes and all(p["labels"]["result"] == "ok" for p in probes),
          f"parity probe gauge {probes}")
    [info] = rep["gauges"][metrics.BUILD_INFO]
    check(info["labels"]["platform"] == "cuda"
          and info["labels"]["native_isa"].startswith("libgear-"),
          f"build_info labels {info['labels']}")
    check(overhead <= 0.02, f"sampler overhead {overhead} above 2%")
    return {"gear_scan_bytes": gear_bytes, "dispatches": dispatches,
            "dispatch_mean_s": None if not dispatches else
            series_sum(rep, "histograms", metrics.DEVICE_DISPATCH_SECONDS,
                       "sum") / dispatches,
            "h2d_bytes": h2d, "chunk_size_observations": sizes,
            "parity_probe": probes, "profiler_overhead_ratio": overhead,
            "build_info": info["labels"],
            "max_progress_gap_s": progress_gap_s(tel, "a", cold),
            "summary": build_telemetry_line(cold)}


def check_warm_telemetry(tel: str, warm: dict) -> dict:
    """(b): no dispatch, no gear bytes, every cache consult a hit (the
    layer's, or the empty sentinel of a step that commits no layer)."""
    from makisu_tpu_torch.utils import metrics
    with open(os.path.join(tel, "R_b.json")) as f:
        rep = json.load(f)
    check(rep["exit_code"] == 0
          and metrics.DEVICE_DISPATCH_SECONDS not in rep["histograms"]
          and "makisu_gear_scan_bytes_total" not in rep["counters"],
          "(b) dispatched or scanned on the card")
    consults = [d for d in read_jsonl(os.path.join(tel, "L_b.jsonl"))
                if d.get("type") == "cache_decision"
                and d.get("source") == "kv"]
    verdicts = [d["verdict"] for d in consults]
    check("hit" in verdicts and set(verdicts) <= {"hit", "empty"},
          f"(b)'s cache consults {verdicts}")
    return {"kv_consults": len(consults), "kv_verdicts": verdicts,
            "summary": build_telemetry_line(warm)}


def cli_run(args: list[str], timeout: float = 120.0) -> tuple:
    """``python -m makisu_tpu_torch.cli ARGS`` as a process of its own:
    (exit code, stdout, seconds)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "makisu_tpu_torch.cli",
                           *args], cwd=repo, capture_output=True, text=True,
                          timeout=timeout)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def telemetry_phase(np, work: str, tel: str, build: dict) -> dict:
    """The readers on (a)'s and (b)'s artifacts, each a process of its
    own, then a forced stall: a 1-file build whose RUN step sleeps 8 s
    under ``--stall-timeout 2`` writes a bundle that ``doctor`` reads,
    and still exits 0."""
    t0 = time.perf_counter()
    out = {"phase": "telemetry", "render_s": {}}
    readers = {
        "report": ["report", os.path.join(tel, "R_a.json"), "--events",
                   os.path.join(tel, "E_a.jsonl")],
        "explain": ["explain", os.path.join(tel, "L_b.jsonl"),
                    "--baseline", os.path.join(tel, "L_a.jsonl")],
        "explain_floor": ["explain", os.path.join(tel, "L_a.jsonl"),
                          "--metrics", os.path.join(tel, "R_a.json")],
        "history": ["history", os.path.join(tel, "H.jsonl")],
        "profile": ["profile", os.path.join(tel, "P_a.json")],
    }
    texts = {}
    for name, args in readers.items():
        rc, text, secs = cli_run(args)
        check(rc == 0 and text.strip(), f"{name} exited {rc}")
        texts[name] = text
        out["render_s"][name] = secs
    hash_s = float(texts["report"].split("hash=")[1].split("s")[0])
    check(hash_s > 0, "(a)'s report shows no hash phase")
    out["report_hash_s"] = hash_s
    from makisu_tpu_torch.utils import traceexport
    with open(os.path.join(tel, "R_a.json")) as f:
        rep = json.load(f)
    # (a)'s own span tree beside the log-line split of phase 7.
    out["a_phase_totals_s"] = traceexport.phase_totals(rep)
    out["a_spans_s"] = {}
    for span, _ in traceexport._walk(traceexport.root_span(rep)):
        name = span["name"] + (f" {span['attrs']['directive']}"
                               if "directive" in span.get("attrs", {})
                               else "")
        out["a_spans_s"][name] = out["a_spans_s"].get(name, 0.0) + \
            (span.get("duration") or 0.0)
    check(texts["history"].count("build") >= 2, "history lacks (a), (b)")

    ctx = os.path.join(work, "stall-ctx")
    os.makedirs(ctx)
    with open(os.path.join(ctx, "f.txt"), "w") as f:
        f.write("stall\n")
    with open(os.path.join(ctx, "Dockerfile"), "w") as f:
        f.write(STALL_DOCKERFILE)
    bundle_path = os.path.join(tel, "stall-bundle.json")
    root = os.path.join(work, "stall-root")
    os.makedirs(root)
    rc, _, secs = cli_run(["--log-fmt", "json", "--log-output",
                           os.path.join(tel, "stall.log"),
                           "--stall-timeout", "2", "--diag-out",
                           bundle_path, "build", ctx, "-t", "smoke/stall:1",
                           "--hasher", "gpu", "--modifyfs", "--storage",
                           os.path.join(work, "stall-storage"), "--root",
                           root], timeout=300)
    check(rc == 0, f"the stalled build exited {rc}")
    with open(bundle_path) as f:
        bundle = json.load(f)
    leaves = [s["name"] for s in bundle["open_spans"] if s.get("leaf")]
    check(bundle["reason"] == "stall" and leaves == ["step"],
          f"stall bundle: reason {bundle['reason']}, open leaves {leaves}")
    rc, doctor, doctor_s = cli_run(["doctor", bundle_path])
    check(rc == 0 and "reason: stall" in doctor and "'step'" in doctor,
          f"doctor exited {rc}")
    out["render_s"]["doctor"] = doctor_s
    out["stall"] = {"build_s": secs, "sections": sorted(bundle),
                    "open_spans": [s["name"] for s in bundle["open_spans"]],
                    "events": len(bundle["events"]),
                    "threads": len(bundle["threads"])}
    cold, warm = build["config3"], build["warm"]
    out["builds"] = {
        "a": {"wall_s": cold["build_wall_s"],
              "commit_wall_s": cold["commit_wall_s"],
              **cold["telemetry"]["summary"]},
        "b": {"wall_s": warm["wall_s"], **warm["telemetry"]["summary"]}}
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 11: a wave of builds through one worker ----------------------------

WAVE_CONCURRENCY = 16   # the worker's --max-concurrent-builds
WAVE_SEEDS = range(100, 100 + WAVE_BUILDS)
WAVE_SESSIONLESS = 4    # contexts also built without worker and service
# The worker's --hash-linger-ms. The wave's commits rarely coincide: at
# the 2 ms default 2-4 of ~60 launches held several builds' passes, at
# 10 ms 5 (measured on one H100). 20 ms keeps the
# cross-build check clear of chance, at most 20 ms per build's commit.
WAVE_LINGER_MS = 20.0


def prom_sum(text: str, name: str) -> float:
    """Sum of every sample of ``name`` in a Prometheus text page."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            total += float(line.rsplit(" ", 1)[1])
    return total


def pcts(values: list) -> dict:
    ordered = sorted(values)
    at = lambda p: ordered[min(len(ordered) - 1,  # noqa: E731
                               max(0, int(len(ordered) * p / 100 + 0.5)
                                   - 1))]
    return {"p50": at(50), "p99": at(99), "max": ordered[-1]}


WAVE_WRITERS = 8   # processes that write the wave's contexts


def context_path(work: str, kind: str, i: int) -> str:
    return os.path.join(work, f"{kind}-ctx{i:02d}")


def contexts_main(kind: str, work: str, first: int, stop: int) -> int:
    """``chip_smoke.py --contexts KIND WORK FIRST STOP``: contexts
    FIRST..STOP-1 of phase 11's wave (KIND ``wave``), phase 14's fleet
    (``fleet``) or phase 16's build (``plane``), each the config-3
    Dockerfile and the phase-2 generator's files at 4 MiB from its
    seed."""
    import numpy as np
    seeds = {"wave": WAVE_SEEDS, "fleet": FLEET_SEEDS,
             "plane": PLANE_SEEDS}[kind]
    for i in range(first, stop):
        ctx = context_path(work, kind, i)
        os.makedirs(ctx)
        with open(os.path.join(ctx, "Dockerfile"), "w") as f:
            f.write(CONFIG3_DOCKERFILE)
        write_context(np, ctx, WAVE_CONTEXT_BYTES, seeds[i])
    return 0


def write_contexts(kind: str, work: str, count: int,
                   writers: int) -> list[str]:
    """``count`` contexts of ``kind``, written by ``writers`` processes of
    this script (the generator is Python-bound: 45.3 s one after another
    on the host of one H100), each waited for."""
    step = -(-count // writers)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--contexts", kind,
         work, str(first), str(min(first + step, count))],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for first in range(0, count, step)]
    errors = [(proc.args[-2:], proc.communicate()[1]) for proc in procs]
    failed = [(span, err[-2000:]) for (span, err), proc in zip(errors, procs)
              if proc.returncode]
    check(not failed, f"writing the {kind} contexts failed: {failed}")
    return [context_path(work, kind, i) for i in range(count)]


def live_descendants() -> list[str]:
    """``pid command`` of every living process below this one, zombies
    reaped. main() makes this process the subreaper of its tree, so a
    process orphaned by one of its children is found here too."""
    parent = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        parent[int(name)] = (int(fields[1]), fields[0],
                             stat[stat.index("(") + 1:stat.rindex(")")])
    below, todo = [], [os.getpid()]
    while todo:
        pid = todo.pop()
        for child, (ppid, state, comm) in parent.items():
            if ppid != pid:
                continue
            todo.append(child)
            if state == "Z" and ppid == os.getpid():
                os.waitpid(child, os.WNOHANG)
            elif state != "Z":
                below.append(f"{child} {comm}")
    return below


def start_cli_process(work: str, name: str, *args: str,
                      env: dict | None = None):
    """``python -m makisu_tpu_torch.cli`` with its JSON log in
    ``work/name.log`` and its stderr in ``work/name.err`` (``env``: extra
    environment variables)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(work, f"{name}.err"), "wb") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "makisu_tpu_torch.cli", "--log-fmt",
             "json", "--log-output", os.path.join(work, f"{name}.log"),
             *args], cwd=repo, stdout=subprocess.DEVNULL, stderr=err,
            env={**os.environ, **(env or {})})


def probed_health(client, who: str, seconds: float = 300) -> dict:
    """The worker's /healthz once its background device probe has ended
    (a worker answers while it runs); fails unless the probe is ok."""
    deadline = time.monotonic() + seconds
    while True:
        health = client.healthz()
        state = health["device"]["probe"]["state"]
        if state not in ("pending", "absent") or \
                time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(state == "ok", f"{who}'s device probe is {state}: "
          f"{health['device']['probe']}")
    return health


def wait_ready(proc, ready, err_path: str, seconds: float = 300) -> None:
    deadline = time.monotonic() + seconds
    while not ready():
        if proc.poll() is not None or time.monotonic() > deadline:
            with open(err_path) as f:
                tail = f.read()[-2000:]
            raise RuntimeError(f"{proc.args[3:]} never came up (rc "
                               f"{proc.poll()}): {tail}")
        time.sleep(0.2)


def worker_phase(torch, np, dev, work: str) -> dict:
    """``python -m makisu_tpu_torch.cli worker`` as a process of its own
    (``--max-concurrent-builds 16``, S1 parity-probed at startup) and a
    wave of WAVE_BUILDS ``build --hasher gpu`` requests submitted at once
    through ``WorkerClient``, each a distinct 4 MiB config-3 context
    (seeds 100-163) with its own storage and root, as that many build
    jobs would be. Every build exits 0; each COPY layer gets (a)'s layer
    checks; WAVE_SESSIONLESS contexts built in this process without
    worker or service give the same chunk lists and images; the worker's
    S1 launches (all multi-buffer, through its hash service) are fewer
    than its layer commits, with at least one cross-build batch; its
    /healthz, /builds, ``sessions`` and ``alerts`` answer for the wave;
    the card's allocated bytes come back within one ring of their value
    after the probe; ``/exit`` ends it with rc 0."""
    from makisu_tpu_torch.chunker.cdc import BLOCK, HALO, ChunkSession
    from makisu_tpu_torch.ops import gear
    from makisu_tpu_torch.utils import metrics
    from makisu_tpu_torch.worker import WorkerClient

    t0 = time.perf_counter()
    out = {"phase": "worker", "builds": WAVE_BUILDS,
           "max_concurrent_builds": WAVE_CONCURRENCY,
           "linger_ms": WAVE_LINGER_MS,
           "context_bytes": WAVE_CONTEXT_BYTES}
    ctxs = write_contexts("wave", work, WAVE_BUILDS, WAVE_WRITERS)
    out["write_s"] = time.perf_counter() - t0
    check(os.environ.get("MAKISU_TPU_SHARED_HASH") is None,
          "the smoke's own builds must not share a hash service")
    sock = os.path.join(work, "worker.sock")
    t1 = time.perf_counter()
    proc = start_cli_process(work, "worker", "--hash-linger-ms",
                             str(WAVE_LINGER_MS), "worker", "--socket", sock,
                             "--max-concurrent-builds", str(WAVE_CONCURRENCY))
    try:
        client = WorkerClient(sock)
        wait_ready(proc, client.ready, os.path.join(work, "worker.err"))
        out["startup_s"] = time.perf_counter() - t1
        before = probed_health(client, "the worker")
        base_launches = before["device"]["kernel_launches"]
        base_bytes = before["device"]["memory"]["allocated_bytes"]

        def one(i):
            c = WorkerClient(sock)
            root = os.path.join(work, f"wave-root{i:02d}")
            os.makedirs(root)
            code = c.build(["--log-level", "error", "build", ctxs[i], "-t",
                            f"wave/app{i:02d}:1", "--hasher", "gpu",
                            "--storage",
                            os.path.join(work, f"wave-storage{i:02d}"),
                            "--root", root])
            return code, c.last_build

        from concurrent.futures import ThreadPoolExecutor
        t2 = time.perf_counter()
        with ThreadPoolExecutor(WAVE_BUILDS) as pool:
            results = list(pool.map(one, range(WAVE_BUILDS)))
        out["wave_s"] = time.perf_counter() - t2
        codes = [code for code, _ in results]
        check(codes == [0] * WAVE_BUILDS, f"wave exit codes {codes}")
        out["client_latency_s"] = pcts([b["elapsed_seconds"]
                                        for _, b in results])
        out["client_queue_wait_s"] = pcts([b["queue_wait_seconds"]
                                           for _, b in results])
        after = client.healthz()
        page = client.metrics()
        builds = client.builds()
        launches = {k: after["device"]["kernel_launches"][k]
                    - base_launches[k] for k in base_launches}
        batches = prom_sum(page, metrics.HASH_BATCHES)
        cross = prom_sum(page, metrics.HASH_CROSS_BUILD_BATCHES)
        passes = prom_sum(page, metrics.HASH_BATCH_FILL + "_sum")
        linger_n = prom_sum(page, metrics.HASH_BATCH_LINGER + "_count")
        out["service"] = {
            "batches": batches, "cross_build_batches": cross,
            "passes": passes, "passes_per_batch": passes / max(batches, 1),
            "occupancy_mean": prom_sum(
                page, metrics.HASH_BATCH_OCCUPANCY + "_sum")
            / max(batches, 1),
            "batch_s_mean": prom_sum(page, metrics.HASH_BATCH_SECONDS
                                     + "_sum") / max(batches, 1),
            "linger_s_mean": prom_sum(page, metrics.HASH_BATCH_LINGER
                                      + "_sum") / max(linger_n, 1),
            "failures": prom_sum(page, metrics.HASH_BATCH_FAILURES)}
        out["launches"] = launches
        rows = []
        for i, ctx in enumerate(ctxs):
            storage = os.path.join(work, f"wave-storage{i:02d}")
            layers = check_committed_layers(torch, np, dev, storage)
            check(len(layers) == 1, f"wave build {i}: {len(layers)} layers "
                  "with cache entries, not its one COPY layer")
            manifest_layers, _ = image_layers(storage, f"wave/app{i:02d}:1")
            check([d["digest"] for d in manifest_layers]
                  == [layers[0]["gzip"]], f"wave build {i}: the manifest's "
                  "layers differ from the committed one")
            rows.extend(layers)
        blocks = sum(-(-row["bytes"] // BLOCK) for row in rows)
        check(launches["gear_bitmap"] == blocks,
              f"G1 launches {launches['gear_bitmap']} != 4 MiB blocks "
              f"{blocks} of the wave's layers")
        check(launches["sha256_spans"] == 0 and passes == len(rows)
              and launches["sha256_multi"] == batches < len(rows)
              and cross >= 1 and out["service"]["failures"] == 0,
              f"service: {launches} launches, {batches} batches "
              f"({cross} cross-build) for {passes} passes of {len(rows)} "
              "layer commits")
        out["layers"] = {"count": len(rows),
                         "bytes": sum(r["bytes"] for r in rows),
                         "chunks": sum(r["chunks"] for r in rows)}
        q = after["queue"]
        check(after["builds_started"] == after["builds_succeeded"]
              == WAVE_BUILDS and after["builds_failed"] == 0
              and after["active_builds"] == 0,
              f"/healthz counts {after['builds_started']} started, "
              f"{after['builds_succeeded']} succeeded")
        check(q["wait_seconds"]["count"] == WAVE_BUILDS
              and q["wait_seconds"]["p99"] > 0
              and q["latency_seconds"]["count"] == WAVE_BUILDS,
              f"/healthz queue {q}")
        out["healthz_queue"] = {"wait_s": q["wait_seconds"],
                                "latency_s": q["latency_seconds"]}
        recent = builds["recent"]
        check(len(recent) == WAVE_BUILDS and all(
            b["state"] == "finished" and b["exit_code"] == 0
            for b in recent), f"/builds lists {len(recent)} recent builds")
        rc, text, _ = cli_run(["sessions", sock])
        resident = after["sessions"]["count"]
        check(rc == 0 and resident > 0 and text.startswith(
            f"{resident} resident session(s)"),
            f"sessions exited {rc}: {text[:200]}")
        rc, alerts_text, _ = cli_run(["alerts", sock])
        check(rc == 0 and "alerts" in alerts_text,
              f"alerts exited {rc}: {alerts_text[:200]}")
        out["sessions_resident"] = resident
        out["alerts"] = alerts_text.strip().splitlines()[:4]
        mem = after["device"]["memory"]
        ring = HALO + -(-gear.DEFAULT_MAX_SIZE // 64) * 64 + \
            ChunkSession.RING_BLOCKS * BLOCK
        out["device_bytes"] = {"after_probe": base_bytes,
                               "after_wave": mem["allocated_bytes"],
                               "peak": mem["max_allocated_bytes"],
                               "ring": ring}
        check(mem["allocated_bytes"] <= base_bytes + ring,
              f"the card holds {mem['allocated_bytes']} bytes after the "
              f"wave, {base_bytes} after the probe (one ring: {ring})")
        # The oracle: the same contexts, in this process, without the
        # worker and its service.
        same = []
        for i in range(WAVE_SESSIONLESS):
            storage = os.path.join(work, f"wave-oracle{i:02d}")
            tag = f"wave/app{i:02d}:1"
            build = run_build(storage, os.path.join(work, f"oracle-root{i}"),
                              ctxs[i], tag,
                              os.path.join(work, f"oracle{i}.log"))
            check(build["launches"]["sha256_spans"] >= 1,
                  f"oracle build {i} launched {build['launches']}")
            wave_storage = os.path.join(work, f"wave-storage{i:02d}")
            check({g: e["chunks"] for g, e in kv_layers(storage).items()}
                  == {g: e["chunks"]
                      for g, e in kv_layers(wave_storage).items()},
                  f"oracle build {i}: chunk lists differ from the wave's")
            check_same_image(storage, wave_storage, tag)
            same.append(build["wall_s"])
        out["oracle_build_s"] = same
        client.exit()
        rc = proc.wait(timeout=60)
        check(rc == 0, f"the worker exited {rc} after /exit")
        out["worker_rc"] = rc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 12: the distributed cache plane -------------------------------------

DIST_BYTES = 64 * MIB       # phases 12-13's monorepo, cut from config 4's 10 GB
DIST_SERVICES = 8           # top-level service directories
DIST_SEED = 31
# The service whose files (l) edits: one of the last COPY's two, as a
# miss breaks the cache chain and every later step would commit again
# (the same bytes) too.
DIST_EDIT_SERVICE = 7
DIST_MAX_FRACTION = 0.05    # PERF.md §2's limit on bytes moved after an edit


def dist_files(np, target: int, seed: int):
    """(path, content) of a monorepo of about ``target`` bytes in
    DIST_SERVICES top-level service directories, BASELINE.md config 4's
    ratio of 100k files to 10 GB: files of 4-192 KiB (mean ~100 KiB),
    four in five text-like (letters, spaces, newlines, braces), the rest
    random bytes. Paths are unique across services, so a COPY of two
    service directories into one destination keeps every file."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz    \n\n{}();=.",
                             dtype=np.uint8)
    total = 0
    i = 0
    while total < target:
        svc = i % DIST_SERVICES
        size = int(rng.integers(4 << 10, (192 << 10) + 1))
        if rng.random() < 0.8:
            content = alphabet[rng.integers(0, len(alphabet), size)].tobytes()
            ext = "ts"
        else:
            content = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            ext = "bin"
        yield (f"svc{svc}/pkg{svc}{i // 400:03d}/f{i:05d}.{ext}", content)
        total += size
        i += 1


def dist_dockerfile() -> str:
    """Four COPY steps, two service directories each, every step
    committed (``--commit explicit``): four layers."""
    return "FROM scratch\n" + "".join(
        f"COPY svc{2 * k} svc{2 * k + 1} /srv/ #!COMMIT\n"
        for k in range(DIST_SERVICES // 2))


def write_dist_context(np, path: str) -> tuple[int, int]:
    os.makedirs(path)
    nfiles = nbytes = 0
    for name, content in dist_files(np, DIST_BYTES, DIST_SEED):
        dst = os.path.join(path, name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(content)
        nfiles += 1
        nbytes += len(content)
    with open(os.path.join(path, "Dockerfile"), "w") as f:
        f.write(dist_dockerfile())
    return nfiles, nbytes


class RespDouble:
    """The smoke's Redis: a RESP2 server on 127.0.0.1 speaking AUTH, GET
    and SET (with EX), string keys in memory. It counts commands by name
    (and SETs carrying EX), never logging an argument."""

    def __init__(self, password: str) -> None:
        import socket
        import threading
        self.password = password
        self.data: dict[bytes, bytes] = {}
        self.counts: dict[str, int] = {}
        self.set_ex = 0
        self.refused = 0
        self._lock = threading.Lock()
        self._sock = socket.create_server(("127.0.0.1", 0))
        self.addr = "127.0.0.1:%d" % self._sock.getsockname()[1]
        self._threads = [threading.Thread(target=self._accept, daemon=True)]
        self._threads[0].start()

    def stop(self) -> None:
        self._sock.close()

    def _accept(self) -> None:
        import threading
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn) -> None:
        buf = b""

        def need(pred):
            nonlocal buf
            while not pred():
                piece = conn.recv(1 << 16)
                if not piece:
                    raise EOFError
                buf += piece

        authed = False
        with conn:
            try:
                while True:
                    need(lambda: b"\r\n" in buf)
                    line, buf = buf.split(b"\r\n", 1)
                    parts = []
                    for _ in range(int(line[1:])):
                        need(lambda: b"\r\n" in buf)
                        hdr, buf = buf.split(b"\r\n", 1)
                        n = int(hdr[1:])
                        need(lambda: len(buf) >= n + 2)
                        parts.append(buf[:n])
                        buf = buf[n + 2:]
                    conn.sendall(self._reply(parts, authed))
                    if parts[0].upper() == b"AUTH":
                        authed = parts[1].decode() == self.password
            except (EOFError, OSError, ValueError):
                return

    def _reply(self, parts: list, authed: bool) -> bytes:
        cmd = parts[0].upper().decode()
        with self._lock:
            self.counts[cmd] = self.counts.get(cmd, 0) + 1
            if cmd == "AUTH":
                if parts[1].decode() == self.password:
                    return b"+OK\r\n"
                self.refused += 1
                return b"-WRONGPASS invalid password\r\n"
            if not authed:
                self.refused += 1
                return b"-NOAUTH Authentication required.\r\n"
            if cmd == "GET":
                value = self.data.get(parts[1])
                return (b"$-1\r\n" if value is None
                        else b"$%d\r\n%s\r\n" % (len(value), value))
            if cmd == "SET":
                self.data[parts[1]] = parts[2]
                if len(parts) >= 5 and parts[3].upper() == b"EX":
                    self.set_ex += 1
                return b"+OK\r\n"
            return b"-ERR unknown command\r\n"


def post_json(sock: str, path: str, doc: dict) -> dict:
    """POST a JSON body on a unix socket; fails unless it answers 200."""
    from makisu_tpu_torch.worker.client import _UnixHTTPConnection
    conn = _UnixHTTPConnection(sock, 30.0)
    try:
        conn.request("POST", path, body=json.dumps(doc).encode())
        resp = conn.getresponse()
        body = resp.read()
        check(resp.status == 200, f"POST {path} on {sock}: {resp.status}")
        return json.loads(body)
    finally:
        conn.close()


def layer_blob_checks(storage: str, manifest: dict, recipes: dict) -> dict:
    """Each layer blob of ``manifest`` against its digest, its gunzipped
    tar against the config's diff_id, and every chunk of its recipe
    (what G1 and S1 cut and hashed at commit) against hashlib on the tar's
    bytes, the rows tiling the tar. Returns bytes and chunk counts."""
    cfg = manifest["config"]["digest"].split(":")[1]
    with open(os.path.join(storage, "layers", cfg[:2], cfg), "rb") as f:
        diff_ids = json.load(f)["rootfs"]["diff_ids"]
    out = {"tar_bytes": 0, "gzip_bytes": 0, "chunks": 0}
    for desc, diff_id in zip(manifest["layers"], diff_ids):
        hexd = desc["digest"].split(":")[1]
        with open(os.path.join(storage, "layers", hexd[:2], hexd), "rb") as f:
            blob = f.read()
        check(hashlib.sha256(blob).hexdigest() == hexd
              and len(blob) == desc["size"], f"layer blob {hexd} differs")
        tar = gzip.decompress(blob)
        check("sha256:" + hashlib.sha256(tar).hexdigest() == diff_id,
              f"layer {hexd}: its tar differs from the diff_id")
        rows = recipes[hexd]["chunks"]
        pos = 0
        for fp, length, _pack, _off in rows:
            check(hashlib.sha256(tar[pos:pos + length]).hexdigest() == fp,
                  f"layer {hexd}: the chunk at {pos} differs from {fp}")
            pos += length
        check(pos == len(tar), f"layer {hexd}: chunks end at {pos} of "
              f"{len(tar)} bytes")
        out["tar_bytes"] += len(tar)
        out["gzip_bytes"] += len(blob)
        out["chunks"] += len(rows)
    return out


def read_recipes(storage: str) -> dict:
    rdir = os.path.join(storage, "serve", "recipes")
    out = {}
    for name in os.listdir(rdir):
        with open(os.path.join(rdir, name)) as f:
            out[name[:-len(".json")]] = json.load(f)
    return out


def distribution_phase(torch, np, dev, work: str, resp, reg,
                       password: str) -> dict:
    """BASELINE.md config 4's cache plane on the card: a Redis KV (the
    smoke's RESP double, with a password), the port's miniregistry, two
    ``makisu_tpu_torch.cli worker`` processes A and B (each its own
    storage) told of each other with ``POST /peers``. (j) A builds v1
    cold, pushes, publishes 4 recipes; (k) B builds v1 from A's Redis
    entries, every chunk from A by recipe and ranged packs, 0 launches;
    (l) 1% of one service's files edited, A builds v2 (only the dirty
    layer commits) and pushes; (m) B builds v2, only the novel chunks on
    the peer wire; (n) a ``serve`` process over A's storage and a fresh
    storage's ``pull --delta`` of v1, then v2. One JSON line per step.
    The RESP double ``resp`` (its password ``password``) and the
    miniregistry ``reg`` outlive the phase: phase 13 reads A's entries."""
    from makisu_tpu_torch import cli
    from makisu_tpu_torch.worker import WorkerClient

    t0 = time.perf_counter()
    out = {"phase": "distribution", "target_bytes": DIST_BYTES,
           "services": DIST_SERVICES}
    ctx = os.path.join(work, "monorepo")
    out["files"], out["file_bytes"] = write_dist_context(np, ctx)
    out["write_s"] = time.perf_counter() - t0
    procs = {}
    frames: list = []
    try:
        socks = {w: os.path.join(work, f"dist-{w}.sock") for w in "AB"}
        storages = {w: os.path.join(work, f"dist-storage-{w}") for w in "AB"}
        t1 = time.perf_counter()
        for w in "AB":
            procs[w] = start_cli_process(work, f"dist-worker-{w}", "worker",
                                         "--socket", socks[w])
        clients = {w: WorkerClient(socks[w]) for w in "AB"}
        for w in "AB":
            wait_ready(procs[w], clients[w].ready,
                       os.path.join(work, f"dist-worker-{w}.err"))
            probed_health(clients[w], f"worker {w}")
        out["startup_s"] = time.perf_counter() - t1
        for w in "AB":
            got = post_json(socks[w], "/peers",
                            {"peers": [socks["A"], socks["B"]],
                             "version": 1})
            check(got == {"applied": True, "version": 1},
                  f"POST /peers on {w}: {got}")

        def metrics_of(w) -> dict:
            page = clients[w].metrics()
            names = {"peer_pack_requests": "makisu_serve_peer_pack_requests_total",
                     "peer_pack_bytes": "makisu_serve_peer_pack_bytes_total",
                     "peer_chunk_hits": "makisu_fleet_peer_chunk_hits_total",
                     "peer_chunk_bytes": "makisu_fleet_peer_chunk_bytes_total",
                     "chunk_serves": "makisu_fleet_chunk_serves_total",
                     "pack_requests_served": "makisu_serve_pack_requests_total",
                     "wire_bytes_served": "makisu_serve_wire_bytes_total"}
            return {k: prom_sum(page, v) for k, v in names.items()}

        def build(w: str, tag: str, push: bool) -> dict:
            root = os.path.join(work, f"dist-root-{w}-{tag}")
            os.makedirs(root)
            argv = ["build", ctx, "-t", f"dist/app:{tag}", "--hasher", "gpu",
                    "--commit", "explicit", "--storage", storages[w],
                    "--root", root, "--redis-cache-addr", resp.addr,
                    "--redis-cache-password", password]
            if push:
                argv += ["--push", reg.addr]
            before_l = clients[w].healthz()["device"]["kernel_launches"]
            before_m = {v: metrics_of(v) for v in "AB"}
            lines: list = []
            t = time.perf_counter()
            code = clients[w].build(argv, on_line=lines.append)
            wall = time.perf_counter() - t
            frames.extend(lines)
            msgs = [ln.get("msg", "") for ln in lines]
            errors = [ln.get("msg") for ln in lines
                      if ln.get("level") == "error"]
            check(code == 0, f"{w}'s build of v{tag} exited {code}: {errors}")
            after_l = clients[w].healthz()["device"]["kernel_launches"]
            moved = {v: {k: x - before_m[v][k]
                         for k, x in metrics_of(v).items()} for v in "AB"}
            return {"wall_s": wall,
                    "launches": {k: after_l[k] - before_l[k]
                                 for k in before_l},
                    "committed": sum(m.startswith("committed layer ")
                                     for m in msgs),
                    "hits": [m for m in msgs if m.startswith("cache hit ")],
                    "peer_lines": [m for m in msgs
                                   if " missing chunks from peer " in m],
                    "metrics": moved}

        def manifest_of(w: str, tag: str) -> dict:
            return local_manifest(storages[w], "dist/app", tag)

        # (j) A builds v1 cold and pushes.
        a1 = build("A", "1", True)
        check(a1["committed"] == 4 and a1["launches"]["gear_bitmap"] > 0
              and a1["launches"]["sha256_multi"] > 0
              and a1["launches"]["sha256_spans"] == 0,
              f"A's v1: {a1['committed']} layers, launches {a1['launches']}")
        deadline = time.monotonic() + 120
        while clients["A"].healthz()["serve"]["recipes"] < 4:
            check(time.monotonic() < deadline,
                  f"A's /healthz serve section: "
                  f"{clients['A'].healthz()['serve']}")
            time.sleep(0.5)
        serve_a = clients["A"].healthz()["serve"]
        v1 = manifest_of("A", "1")
        check(registry_manifest(reg, "dist/app", "1") == v1,
              "the registry's v1 manifest differs from A's")
        check_registry_blobs(reg, "dist/app", v1)
        recipes = read_recipes(storages["A"])
        layers1 = layer_blob_checks(storages["A"], v1, recipes)
        v1_hex = [d["digest"].split(":")[1] for d in v1["layers"]]
        distinct1 = {row[0] for hx in v1_hex for row in recipes[hx]["chunks"]}
        out["j_a_v1"] = {"wall_s": a1["wall_s"], "launches": a1["launches"],
                         "layers": a1["committed"], **layers1,
                         "distinct_chunks": len(distinct1),
                         "serve": serve_a}
        emit({"phase": "distribution", "step": "j_a_v1", **out["j_a_v1"]})

        # (k) B builds v1: every layer a KV hit, its chunks from A.
        b1 = build("B", "1", False)
        mb, ma = b1["metrics"]["B"], b1["metrics"]["A"]
        check(b1["committed"] == 0 and len(b1["hits"]) == 4
              and all(h.endswith("chunks available)") for h in b1["hits"])
              and not any(b1["launches"].values()),
              f"B's v1: {b1['committed']} committed, hits {b1['hits']}, "
              f"launches {b1['launches']}")
        # Each layer's missing chunks, a chunk shared by two layers
        # counted by each that fetched it.
        per_layer = sum(len({row[0] for row in recipes[hx]["chunks"]})
                        for hx in v1_hex)
        check(len(distinct1) <= mb["peer_chunk_hits"] <= per_layer
              and mb["peer_pack_requests"] >= 1
              and ma["pack_requests_served"] >= mb["peer_pack_requests"]
              and ma["chunk_serves"] == 0,
              f"B's v1 peer wire: B {mb}, A {ma} "
              f"({len(distinct1)} distinct chunks)")
        check([d["digest"] for d in manifest_of("B", "1")["layers"]]
              == [d["digest"] for d in v1["layers"]],
              "B's v1 layers differ from A's")
        out["k_b_v1"] = {"wall_s": b1["wall_s"], "launches": b1["launches"],
                         "hits": len(b1["hits"]),
                         "peer_requests": mb["peer_pack_requests"],
                         "peer_bytes": mb["peer_pack_bytes"],
                         "peer_chunks": mb["peer_chunk_hits"],
                         "served_requests": ma["pack_requests_served"],
                         "served_wire_bytes": ma["wire_bytes_served"],
                         "per_chunk_serves": ma["chunk_serves"]}
        emit({"phase": "distribution", "step": "k_b_v1", **out["k_b_v1"]})

        # (l) 16 bytes appended to 1% of one service's files; A builds v2.
        svc_dir = os.path.join(ctx, f"svc{DIST_EDIT_SERVICE}")
        svc_files = sorted(os.path.join(d, n) for d, _, ns in os.walk(svc_dir)
                           for n in ns)
        edited = svc_files[::100]
        for path in edited:
            with open(path, "ab") as f:
                f.write(b"/* edit 0001 */\n")
        a2 = build("A", "2", True)
        v2 = manifest_of("A", "2")
        v2_hex = [d["digest"].split(":")[1] for d in v2["layers"]]
        dirty = [i for i in range(4) if v2_hex[i] != v1_hex[i]]
        check(a2["committed"] == 1 and dirty == [DIST_EDIT_SERVICE // 2]
              and a2["launches"]["gear_bitmap"] > 0
              and a2["launches"]["sha256_multi"] > 0,
              f"A's v2: {a2['committed']} committed, dirty layers {dirty}, "
              f"launches {a2['launches']}")
        deadline = time.monotonic() + 120
        while clients["A"].healthz()["serve"]["recipes"] < 5:
            check(time.monotonic() < deadline, "A never published v2's "
                  "recipe")
            time.sleep(0.5)
        recipes = read_recipes(storages["A"])
        dirty_hex = v2_hex[dirty[0]]
        layers2 = layer_blob_checks(
            storages["A"], {"config": v2["config"],
                            "layers": v2["layers"]}, recipes)
        dirty_rows = recipes[dirty_hex]["chunks"]
        dirty_bytes = sum(row[1] for row in dirty_rows)
        novel = {row[0]: row[1] for row in dirty_rows
                 if row[0] not in distinct1}
        out["l_a_v2"] = {"wall_s": a2["wall_s"], "launches": a2["launches"],
                         "edited_files": len(edited),
                         "dirty_layer_bytes": dirty_bytes,
                         "novel_chunks": len(novel),
                         "novel_bytes": sum(novel.values()),
                         "image_tar_bytes": layers2["tar_bytes"]}
        emit({"phase": "distribution", "step": "l_a_v2", **out["l_a_v2"]})

        # (m) B builds v2: only the dirty layer's novel chunks move.
        b2 = build("B", "2", False)
        mb, ma = b2["metrics"]["B"], b2["metrics"]["A"]
        check(b2["committed"] == 0 and len(b2["hits"]) == 4
              and not any(b2["launches"].values()),
              f"B's v2: {b2['committed']} committed, hits {b2['hits']}, "
              f"launches {b2['launches']}")
        check(mb["peer_chunk_hits"] == len(novel)
              and ma["chunk_serves"] == 0
              and 0 < mb["peer_pack_bytes"]
              <= DIST_MAX_FRACTION * dirty_bytes,
              f"B's v2 peer wire: B {mb}, A {ma}; {len(novel)} novel "
              f"chunks, dirty layer {dirty_bytes} B")
        check([d["digest"] for d in manifest_of("B", "2")["layers"]]
              == [d["digest"] for d in v2["layers"]],
              "B's v2 layers differ from A's")
        out["m_b_v2"] = {"wall_s": b2["wall_s"], "launches": b2["launches"],
                         "peer_requests": mb["peer_pack_requests"],
                         "peer_bytes": mb["peer_pack_bytes"],
                         "peer_chunks": mb["peer_chunk_hits"],
                         "peer_fraction_of_dirty_layer":
                             mb["peer_pack_bytes"] / dirty_bytes}
        emit({"phase": "distribution", "step": "m_b_v2", **out["m_b_v2"]})

        # (n) a serve process over A's storage; C delta-pulls v1, then v2.
        serve_sock = os.path.join(work, "dist-serve.sock")
        procs["serve"] = start_cli_process(work, "dist-serve", "serve",
                                           "--socket", serve_sock,
                                           "--storage", storages["A"])
        from makisu_tpu_torch.serve import ServeClient
        sc = ServeClient(serve_sock)
        wait_ready(procs["serve"], sc.ready,
                   os.path.join(work, "dist-serve.err"), 120)
        storage_c = os.path.join(work, "dist-storage-C")
        pulls = {}
        for tag, manifest in (("1", v1), ("2", v2)):
            report = os.path.join(work, f"dist-pull{tag}.json")
            t = time.perf_counter()
            rc = cli.main(["--log-fmt", "json", "--log-output",
                           os.path.join(work, f"dist-pull{tag}.log"),
                           "pull", f"{reg.addr}/dist/app:{tag}",
                           "--storage", storage_c, "--delta", serve_sock,
                           "--report-out", report])
            wall = time.perf_counter() - t
            check(rc == 0, f"pull --delta of v{tag} exited {rc}")
            with open(report) as f:
                rep = json.load(f)
            for desc in manifest["layers"]:
                hexd = desc["digest"].split(":")[1]
                got = sha256_file(os.path.join(storage_c, "layers",
                                               hexd[:2], hexd))
                check(got == (hexd, desc["size"]),
                      f"delta-pulled layer {hexd} differs from the "
                      "registry's digest")
            pulls[tag] = {"wall_s": wall, **{k: rep[k] for k in (
                "bytes_fetched", "bytes_raw_wire", "bytes_full_image",
                "fetched_fraction", "delta_layers", "fallback_layers")},
                "requests": sum(r.get("requests", 0) for r in rep["layers"])}
        check(pulls["1"]["delta_layers"] == 4
              and pulls["1"]["fallback_layers"] == 0
              and pulls["2"]["delta_layers"] == 1
              and pulls["2"]["fallback_layers"] == 0,
              f"delta pulls: {pulls}")
        check(pulls["2"]["bytes_fetched"]
              <= DIST_MAX_FRACTION * pulls["2"]["bytes_full_image"],
              f"v2's delta pull moved {pulls['2']['bytes_fetched']} of "
              f"{pulls['2']['bytes_full_image']} bytes")
        out["n_delta_pull"] = pulls
        emit({"phase": "distribution", "step": "n_delta_pull", **pulls})
        # What phase 13 starts from: A's storage and its serve digest.
        out["a_storage"] = storages["A"]
        out["a_serve"] = clients["A"].healthz()["serve"]
        out["context"] = ctx

        # Every process ends: the serve process on /exit, the workers too.
        for name, sock in (("serve", serve_sock), ("A", socks["A"]),
                           ("B", socks["B"])):
            WorkerClient(sock).exit()  # the same /exit on either server
            rc = procs[name].wait(timeout=60)
            check(rc == 0, f"{name} exited {rc}")
        with resp._lock:
            counts = dict(resp.counts)
        check(counts.get("AUTH", 0) >= 4 and resp.set_ex >= 5
              and resp.set_ex == counts.get("SET")
              and counts.get("GET", 0) >= 8 and resp.refused == 0,
              f"the RESP double saw {counts}, {resp.set_ex} SET EX, "
              f"{resp.refused} refused")
        out["kv_commands"] = {**counts, "set_ex": resp.set_ex}
        # The password in no artifact and no log.
        leaks = [json.dumps(f) for f in frames if password in json.dumps(f)]
        for dirpath, dirs, names in os.walk(work):
            dirs[:] = [d for d in dirs if d not in ("chunks", "layers",
                                                    "monorepo")]
            for name in names:
                path = os.path.join(dirpath, name)
                st = os.lstat(path)
                if not stat.S_ISREG(st.st_mode) or st.st_size > 64 * MIB:
                    continue
                with open(path, "rb") as f:
                    if password.encode() in f.read():
                        leaks.append(path)
        check(not leaks, f"the Redis password leaked into {leaks[:5]}")
        out["seconds"] = time.perf_counter() - t0
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# -- phase 13: storage governance over phase 12's storage -------------------

STORAGE_NEW_BYTES = 16 * MIB  # (r)'s cold one-layer context (config-3 mix)
STORAGE_SEED = 41
STORAGE_SCRUB_SECONDS = "2"   # worker C's scrub cadence, so /storage has one


def count_chunk_files(storage: str) -> tuple[int, int]:
    """(chunk files, session-snapshot recipes): the chunk plane's
    objects, counted by the smoke itself."""
    chunks = 0
    root = os.path.join(storage, "chunks")
    for shard in os.listdir(root):
        if shard == "_tmp" or not os.path.isdir(os.path.join(root, shard)):
            continue
        chunks += sum(1 for n in os.listdir(os.path.join(root, shard))
                      if not n.endswith(".tmp"))
    snap_dir = os.path.join(storage, "serve", "snapshots")
    snaps = (sum(1 for n in os.listdir(snap_dir) if n.endswith(".json"))
             if os.path.isdir(snap_dir) else 0)
    return chunks, snaps


def storage_phase(torch, np, dev, work: str, dist: dict, resp, reg,
                  password: str) -> dict:
    """BASELINE.md config 4's storage, governed: phase 12's worker A
    storage (chunk CAS, packs, seekable-zstd twins, recipes) through the
    port's CLI and a worker. (o) ``du --json`` as a process: the chunk
    plane's objects equal the smoke's count of chunk files (and snapshot
    recipes), the pack tables and recipes A's last /healthz serve digest.
    (p) ``doctor --storage DIR``: rc 0, no finding; a scrub checks chunks
    and a zpack frame. (q) ``doctor --storage DIR --eviction-budget N``,
    N half the hot tier: the dry run's victims and bytes. (r) worker C
    over that storage with ``--storage-budget`` N (MiB) and
    ``--storage-remote``, builds a new 16 MiB context cold on G1 and S1:
    after it the hot tier is at most N, every victim (q) named is gone,
    /healthz pressure is at most 1, /storage and ``doctor --storage
    SOCKET`` read it. (s) C builds v2 of phase 12's monorepo with the
    layer whose chunks (r) demoted missing its blob: its chunks come
    back from the pack or remote tier (a ``chunk_fetch`` on the ``tier``
    route), no request to a peer or the registry, no launch, and the
    image's layers and config equal phase 12's v2."""
    from makisu_tpu_torch.cache import census as census_mod
    from makisu_tpu_torch.storage import contentstore
    from makisu_tpu_torch.worker import WorkerClient

    t0 = time.perf_counter()
    storage = dist["a_storage"]
    out = {"phase": "storage", "storage_dir": storage}
    # Phase 12's v2 image, before any eviction: its config blob is a
    # blob like any other, and (r) may evict it.
    v2 = local_manifest(storage, "dist/app", "2")
    v2_config = timeless_config(storage, "dist/app:2")
    v2_diff_ids = v2_config["rootfs"]["diff_ids"]

    # (o) du --json, a process of its own.
    rc, text, du_s = cli_run(["du", "--storage", storage, "--json"])
    check(rc == 0, f"du exited {rc}")
    doc = json.loads(text)
    chunk_files, snapshots = count_chunk_files(storage)
    planes = doc["planes"]
    serve = dist["a_serve"]
    check(planes["chunks"]["objects"] == chunk_files + snapshots
          and planes["chunks"]["snapshots"] == snapshots
          and planes["packs"]["tables"] == serve["packs"]
          and planes["packs"]["zpacks"] == serve["zpacks"]
          and planes["recipes"]["objects"] == serve["recipes"],
          f"du: {planes} against {chunk_files} chunk files, {snapshots} "
          f"snapshots and A's serve digest {serve}")
    out["o_du"] = {"wall_s": du_s, "total_bytes": doc["total_bytes"],
                   "total_objects": doc["total_objects"],
                   **{p: {"objects": planes[p]["objects"],
                          "bytes": planes[p]["bytes"]} for p in planes},
                   "chunk_files": chunk_files, "snapshots": snapshots}
    emit({"phase": "storage", "step": "o_du", **out["o_du"]})

    # (p) doctor --storage DIR: clean; a scrub reads chunks and a frame.
    rc, text, doctor_s = cli_run(["doctor", "--storage", storage])
    check(rc == 0 and "no findings" in text,
          f"doctor --storage exited {rc}: {text[-2000:]}")
    t = time.perf_counter()
    scrub = census_mod.StorageCensus(storage).scrub()
    scrub_s = time.perf_counter() - t
    check(scrub["chunks_checked"] >= 1 and scrub["packs_checked"] >= 1
          and not scrub["findings"], f"the scrub: {scrub}")
    out["p_doctor"] = {"wall_s": doctor_s, "scrub_s": scrub_s,
                       **{k: scrub[k] for k in ("chunks_checked",
                                                "packs_checked",
                                                "bytes_read")}}
    emit({"phase": "storage", "step": "p_doctor", **out["p_doctor"]})

    # (q) the eviction dry run at half the hot tier.
    hot = contentstore.store_for(storage).tier_bytes(publish=False)["hot"]
    budget_mib = (hot // 2) >> 20
    budget = budget_mib << 20
    rc, text, dry_s = cli_run(["doctor", "--storage", storage,
                               "--eviction-budget", str(budget)])
    dry = census_mod.StorageCensus(storage).eviction_dry_run(budget)
    said = re.search(r"eviction dry-run @ [^:]+: evict (\d+) objects", text)
    check(rc == 0 and said and int(said.group(1)) == dry["evict_count"] > 0
          and dry["freed_bytes"] >= hot - budget,
          f"doctor --eviction-budget {budget} exited {rc}: {dry}")
    victims = [(v["plane"], v["object"]) for v in dry["would_evict"]]
    out["q_dry_run"] = {"wall_s": dry_s, "hot_bytes": hot,
                        "budget_bytes": budget,
                        "evict_count": dry["evict_count"],
                        "freed_bytes": dry["freed_bytes"],
                        "actions": dry["actions"]}
    emit({"phase": "storage", "step": "q_dry_run", **out["q_dry_run"]})

    # (r) worker C, budgeted, builds a new context cold.
    sock = os.path.join(work, "storage-C.sock")
    remote = os.path.join(work, "storage-remote")
    proc = start_cli_process(
        work, "storage-worker-C", "worker", "--socket", sock,
        "--storage-budget", str(budget_mib), "--storage-remote", remote,
        env={"MAKISU_TPU_STORAGE_EVICT_SECONDS": "0",
             "MAKISU_TPU_STORAGE_SCRUB_SECONDS": STORAGE_SCRUB_SECONDS})
    frames: list = []
    try:
        client = WorkerClient(sock)
        t = time.perf_counter()
        wait_ready(proc, client.ready,
                   os.path.join(work, "storage-worker-C.err"))
        probed_health(client, "worker C")
        out["startup_s"] = time.perf_counter() - t

        def build(argv: list, tag: str) -> dict:
            root = os.path.join(work, f"storage-root-{tag}")
            os.makedirs(root)
            before = client.healthz()["device"]["kernel_launches"]
            page = client.metrics()
            lines: list = []
            evs: list = []
            t = time.perf_counter()
            code = client.build(argv + ["--storage", storage, "--root",
                                        root], on_line=lines.append,
                                on_event=evs.append)
            wall = time.perf_counter() - t
            frames.extend(lines + evs)
            errors = [ln.get("msg") for ln in lines
                      if ln.get("level") == "error"]
            check(code == 0, f"C's build {tag} exited {code}: {errors}")
            after = client.healthz()["device"]["kernel_launches"]
            moved = client.metrics()
            return {"wall_s": wall, "lines": lines, "events": evs,
                    "launches": {k: after[k] - before[k] for k in before},
                    "peer_wire": sum(
                        prom_sum(moved, name) - prom_sum(page, name)
                        for name in ("makisu_fleet_peer_chunk_hits_total",
                                     "makisu_serve_peer_pack_requests_total",
                                     "makisu_fleet_chunk_serves_total"))}

        ctx = os.path.join(work, "storage-ctx")
        os.makedirs(ctx)
        with open(os.path.join(ctx, "Dockerfile"), "w") as f:
            f.write(CONFIG3_DOCKERFILE)
        files, nbytes = write_context(np, ctx, STORAGE_NEW_BYTES,
                                      STORAGE_SEED)
        cold = build(["build", ctx, "-t", "storage/app:1",
                      "--hasher", "gpu"], "cold")
        health = client.healthz()["storage"]
        hot_after = contentstore.store_for(storage).tier_bytes(
            publish=False)["hot"]
        gone = [(p, n) for p, n in victims if not os.path.exists(
            os.path.join(storage, "chunks" if p == "chunks" else "layers",
                         n[:2], n))]
        check(cold["launches"]["gear_bitmap"] > 0
              and cold["launches"]["sha256_multi"] > 0
              and cold["launches"]["sha256_spans"] == 0,
              f"C's cold build launches: {cold['launches']}")
        check(hot_after <= budget
              and health["budget"]["hot_bytes"] <= budget
              and health["budget"]["budget_bytes"] == budget
              and health["budget"]["pressure"] <= 1.0
              and health["budget"]["evictions_total"] > 0,
              f"after C's build the hot tier is {hot_after} B against "
              f"{budget}: {health['budget']}")
        check(len(gone) == len(victims),
              f"{len(victims) - len(gone)} of the dry run's "
              f"{len(victims)} victims are still on disk")
        # /storage and doctor --storage SOCKET; the scrub thread's first
        # cycle lands within a few of its periods.
        deadline = time.monotonic() + 60
        while True:
            report = client.storage(eviction_budget=budget)
            (entry,) = [e for e in report["storage"]
                        if e["storage_dir"] == os.path.realpath(storage)]
            if entry["scrub"].get("chunks_checked", 0) > 0:
                break
            check(time.monotonic() < deadline,
                  f"/storage shows no scrub cycle: {entry['scrub']}")
            time.sleep(0.5)
        audit = entry["audit"]
        check({"census", "audit", "contentstore", "scrub"} <= set(entry)
              and not [f for f in audit["findings"]
                       if f["severity"] == "error"]
              and audit["classification"]["chunks"]["demoted"] > 0
              and entry["contentstore"]["budget_bytes"] == budget
              and entry["contentstore"]["remote_tier"] == remote,
              f"C's /storage: {sorted(entry)}, "
              f"{audit['classification']}, {audit['findings'][:3]}, "
              f"{entry.get('contentstore')}")
        rc, text, sock_doctor_s = cli_run(["doctor", "--storage", sock])
        check(rc in (0, 1) and f"== {os.path.realpath(storage)}" in text
              and "content store: budget" in text,
              f"doctor --storage on C's socket exited {rc}: {text[-2000:]}")
        evicted = [ln.get("msg", "") for ln in cold["lines"]
                   if ln.get("msg", "").startswith("evicted ")]
        out["r_budget_build"] = {
            "wall_s": cold["wall_s"], "launches": cold["launches"],
            "files": files, "bytes": nbytes,
            "hot_bytes_after": hot_after, "budget_bytes": budget,
            "pressure": health["budget"]["pressure"],
            "evictions_total": health["budget"]["evictions_total"],
            "evicted_bytes": health["budget"]["evicted_bytes"],
            "tiers": entry["contentstore"]["tiers"],
            "demoted_chunks": audit["classification"]["chunks"]["demoted"],
            "dry_run_victims_gone": len(gone),
            "scrub": entry["scrub"], "doctor_socket_s": sock_doctor_s,
            "eviction_lines": evicted[:4]}
        emit({"phase": "storage", "step": "r_budget_build",
              **out["r_budget_build"]})

        # (s) v2 of the monorepo on C: the layer with the most demoted
        # chunks, its blob gone, comes back from the tiers alone.
        recipes = read_recipes(storage)
        v2_hex = [d["digest"].split(":")[1] for d in v2["layers"]]
        demoted = {hx: sum(1 for row in recipes[hx]["chunks"]
                           if not os.path.exists(os.path.join(
                               storage, "chunks", row[0][:2], row[0])))
                   for hx in v2_hex}
        layer = max(v2_hex, key=lambda hx: demoted[hx])
        check(demoted[layer] > 0, f"(r) demoted no chunk of v2: {demoted}")
        blob = os.path.join(storage, "layers", layer[:2], layer)
        with contextlib.suppress(FileNotFoundError):
            os.unlink(blob)
        requests_before = len(reg.state.requests)
        budget_before = client.healthz()["storage"]["budget"]
        dest = os.path.join(work, "storage-v2.tar")
        warm = build(["build", dist["context"], "-t", "dist/app:2",
                      "--hasher", "gpu", "--commit", "explicit",
                      "--redis-cache-addr", resp.addr,
                      "--redis-cache-password", password,
                      "--dest", dest], "tier")
        budget_after = client.healthz()["storage"]["budget"]
        fetches = [e for e in warm["events"]
                   if e.get("type") == "chunk_fetch"]
        tier = [e for e in fetches if e.get("route") == "tier"]
        msgs = [ln.get("msg", "") for ln in warm["lines"]]
        check(tier and all(e.get("route") == "tier" for e in fetches)
              and sum(e.get("bytes", 0) for e in tier) > 0
              and budget_after["refetch_bytes"]
              > budget_before["refetch_bytes"],
              f"(s) chunk fetches {fetches}, refetch bytes "
              f"{budget_before['refetch_bytes']} -> "
              f"{budget_after['refetch_bytes']}")
        check(not any(warm["launches"].values())
              and not any(m.startswith("committed layer ") for m in msgs)
              and len(reg.state.requests) == requests_before
              and warm["peer_wire"] == 0,
              f"(s) launches {warm['launches']}, registry requests "
              f"{len(reg.state.requests) - requests_before}, peer wire "
              f"{warm['peer_wire']}")
        with tarfile.open(dest) as tf:
            [export] = json.load(tf.extractfile("manifest.json"))
            got_ids = []
            for name in export["Layers"]:
                h = hashlib.sha256()
                with tf.extractfile(name) as f:
                    while piece := f.read(16 * MIB):
                        h.update(piece)
                got_ids.append("sha256:" + h.hexdigest())
            # The config from the tar: the storage's copy is a blob the
            # build's own eviction pass may already have taken.
            config = json.load(tf.extractfile(export["Config"]))
        config.pop("created", None)
        for h in config.get("history", []):
            h.pop("created", None)
        check(got_ids == v2_diff_ids and config == v2_config
              and [d["digest"] for d in local_manifest(
                  storage, "dist/app", "2")["layers"]]
              == [d["digest"] for d in v2["layers"]],
              "(s)'s image differs from phase 12's v2")
        out["s_tier_refetch"] = {
            "wall_s": warm["wall_s"], "launches": warm["launches"],
            "layer": layer, "demoted_chunks": demoted[layer],
            "refetched_chunks": sum(e.get("fetched", 0) for e in tier),
            "refetch_bytes": sum(e.get("bytes", 0) for e in tier),
            "registry_requests": len(reg.state.requests) - requests_before,
            "image_layers": len(got_ids)}
        emit({"phase": "storage", "step": "s_tier_refetch",
              **out["s_tier_refetch"]})
        os.unlink(dest)
        client.exit()
        rc = proc.wait(timeout=60)
        check(rc == 0, f"worker C exited {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    leaks = [json.dumps(f) for f in frames if password in json.dumps(f)]
    for name in ("storage-worker-C.log", "storage-worker-C.err"):
        with open(os.path.join(work, name), "rb") as f:
            if password.encode() in f.read():
                leaks.append(name)
    check(not leaks, f"the Redis password leaked into {leaks[:5]}")
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 14: the fleet front door ---------------------------------------------

FLEET_WORKERS = 3
FLEET_CONTEXTS = 6
FLEET_SEEDS = range(61, 61 + FLEET_CONTEXTS)
FLEET_WORKER_CONCURRENCY = 4   # each worker's --max-concurrent-builds
FLEET_TENANTS = ("team-a", "team-b")
FLEET_TENANT_QUOTA = 2
FLEET_CANARY_INTERVAL = 5.0
# (v)'s build, killed mid-build on its worker: a small context of the
# phase-2 generator whose RUN keeps it there for the kill. The RUN comes
# first: both attempts build in the one --root the request names, and a
# COPY the killed attempt had applied there would show in the survivor's
# RUN layer (its directory's mtime), which a fresh root's build lacks.
FLEET_FAILOVER_BYTES = 1 * MIB
FLEET_FAILOVER_SEED = 67
FLEET_FAILOVER_DOCKERFILE = "FROM scratch\nRUN sleep 3\nCOPY . /app/\n"


def append_to_one_percent(np, ctx: str, seed: int) -> int:
    """Append 16 bytes to 1% of the context's files (at least one),
    chosen by a seeded rng; the Dockerfile stays as it is."""
    rng = np.random.default_rng(seed)
    paths = sorted(os.path.join(d, n) for d, _, names in os.walk(ctx)
                   for n in names if n != "Dockerfile")
    picked = rng.choice(len(paths), size=max(1, len(paths) // 100),
                        replace=False)
    for i in picked.tolist():
        with open(paths[i], "ab") as f:
            f.write(b"/* fleet edit */"[:16])
    return len(picked)


def shared_layer_entries(kv) -> dict[str, dict]:
    """``layer_entries`` of everything in an in-process SharedKVServer."""
    with kv._mu:
        values = list(kv._data.values())
    return layer_entries(values)


def fleet_layer_checks(torch, np, dev, storage: str,
                       shared: dict) -> tuple[dict, set]:
    """``check_committed_layers`` over a fleet worker's storage: every
    layer it holds with an entry in the shared KV (its routed builds') or
    in its own KV file (its canary's, built without the shared KV).
    Returns (gzip digest -> row, the gzip digests of its own file)."""
    own = (kv_layers(storage) if os.path.exists(
        os.path.join(storage, "cache_key_value.json")) else {})
    rows = check_committed_layers(torch, np, dev, storage,
                                  entries={**shared, **own})
    return {row["gzip"]: row for row in rows}, set(own)


def fleet_phase(torch, np, dev, work: str) -> dict:
    """The port's fleet front door on the card (BASELINE.md config 5's
    build farm behind one socket). Three ``worker`` processes (each its
    own storage, ``--max-concurrent-builds 4``, S1 parity-probed), one
    shared HTTP KV in this process, and one ``fleet`` process in front
    with ``--events-out``, ``--trace-out``, a tenant quota of 2 and
    canaries every 5 s (``--hasher gpu``). Six config-3 contexts (seeds
    61-66, 4 MiB each), two tenants. (t) all six at once, cold: each
    lands on its context's ring owner, or past a saturated owner (the
    default spillover depth) on the least-loaded worker. (u) 16 bytes
    appended to 1% of each context's files: every build routes affinity
    and commits its one dirty layer. (v) the holder of context 0
    drained, a second worker SIGKILLed while a build runs on it, which
    fails over to the third. (w) the six again, unchanged: every build
    exits 0, the displaced ones relocate or fail over, every layer
    equals (u)'s and a worker-less ``build --hasher gpu`` process's of
    the same context (the seven, (v)'s too, run beside (w)); peer chunk
    hits or a prewarm; launches per
    worker; a canary per alive worker. (x) ``top``, ``doctor --fleet``,
    ``alerts``, ``profile --fleet`` as processes, ``/exit``, ``report
    --fleet`` on the event log, the merged trace with one trace id per
    routed build. (y) ``loadgen --fleet --workers 3 --rounds 3 --hasher
    gpu`` as a process beside (t)-(x): rc 0, every digest identical, the
    kill's builds completed elsewhere. After (u) and after (w) every
    layer in every worker's storage gets (a)'s layer checks (chunks
    against hashlib, cuts against the plain Gear version), and after (u)
    each worker's G1 launches equal the 4 MiB blocks of the layers it
    committed, its S1 launches its hash batches."""
    from concurrent.futures import ThreadPoolExecutor

    from makisu_tpu_torch.chunker.cdc import BLOCK
    from makisu_tpu_torch.fleet.kv import SharedKVServer
    from makisu_tpu_torch.fleet.scheduler import FleetScheduler, WorkerSpec
    from makisu_tpu_torch.utils import metrics
    from makisu_tpu_torch.worker import WorkerClient

    t0 = time.perf_counter()
    out = {"phase": "fleet", "card": nvidia_smi("name,power.limit"),
           "workers": FLEET_WORKERS, "contexts": FLEET_CONTEXTS,
           "context_bytes": WAVE_CONTEXT_BYTES}
    loadgen_report = os.path.join(work, "fleet-loadgen.json")
    kv = SharedKVServer()
    kv_addr = kv.start()
    ids = [f"w{k}" for k in range(FLEET_WORKERS)]
    socks = {w: os.path.join(work, f"fleet-{w}.sock") for w in ids}
    storages = {w: os.path.join(work, f"fleet-{w}-storage") for w in ids}
    front_sock = os.path.join(work, "fleet-front.sock")
    events_path = os.path.join(work, "fleet-events.jsonl")
    trace_path = os.path.join(work, "fleet-trace.json")
    workers: dict = {}
    oracles: list = []
    front = loadgen = None
    killed = ""
    try:
        # (y) runs beside (t)-(x): a process of its own with its own
        # in-process workers, so the phase's wall is not the sum of both.
        loadgen = start_cli_process(
            work, "fleet-loadgen", "--log-level", "error", "loadgen",
            "--fleet", "--workers", "3", "--rounds", "3", "--hasher", "gpu",
            "--report", loadgen_report, "--work-dir",
            os.path.join(work, "fleet-loadgen"))
        t1 = time.perf_counter()
        for w in ids:
            workers[w] = start_cli_process(
                work, f"fleet-{w}", "worker", "--socket", socks[w],
                "--max-concurrent-builds", str(FLEET_WORKER_CONCURRENCY))
        # The contexts are written while the workers probe S1.
        ctxs = write_contexts("fleet", work, FLEET_CONTEXTS, FLEET_CONTEXTS)
        keys = [os.path.realpath(c) for c in ctxs]
        out["write_s"] = time.perf_counter() - t1
        for w in ids:
            wait_ready(workers[w], WorkerClient(socks[w]).ready,
                       os.path.join(work, f"fleet-{w}.err"))
        probes = {w: probed_health(WorkerClient(socks[w]), f"worker {w}")
                  ["device"] for w in ids}
        base = {w: p["kernel_launches"] for w, p in probes.items()}
        front = start_cli_process(
            work, "fleet-front", "--events-out", events_path, "--trace-out",
            trace_path, "fleet", "--socket", front_sock,
            *[a for w in ids for a in ("--worker",
                                       f"{socks[w]}={storages[w]}")],
            "--tenant-quota", str(FLEET_TENANT_QUOTA),
            "--canary-interval", str(FLEET_CANARY_INTERVAL),
            "--poll-interval", "0.5")
        client = WorkerClient(front_sock)
        wait_ready(front, client.ready, os.path.join(work, "fleet-front.err"))
        deadline = time.monotonic() + 30
        while not all(w["alive"] for w in client.healthz()["fleet"]
                      ["workers"]):
            check(time.monotonic() < deadline, "the front door never saw "
                  "every worker alive")
            time.sleep(0.2)
        out["startup_s"] = time.perf_counter() - t1
        ring = FleetScheduler([WorkerSpec(w, socks[w]) for w in ids])
        owners = [ring._ring_owner(k, set(ids)) for k in keys]

        def routed(ctx: str, tag: str, tenant: str, root: str,
                   *extra: str) -> dict:
            """One build through the front door; the terminal frame's
            routing fields, its layer commits and its error lines."""
            c = WorkerClient(front_sock)
            os.makedirs(root)
            lines: list = []
            code = c.build(["--log-level", "error", "build", ctx, "-t", tag,
                            "--hasher", "gpu", "--root", root,
                            "--http-cache-addr", kv_addr, *extra],
                           on_line=lines.append, tenant=tenant)
            frame = c.last_build
            return {"code": code, "worker": frame.get("worker"),
                    "verdict": frame.get("fleet_verdict"),
                    "reason": frame.get("fleet_reason", ""),
                    "attempts": frame.get("fleet_attempts"),
                    "quota_wait_s": frame.get("quota_wait_seconds"),
                    "elapsed_s": frame.get("elapsed_seconds", 0.0),
                    "trace_id": frame.get("trace_id", ""),
                    "commits": sum(1 for e in c.last_events
                                   if e.get("type") == "span_start"
                                   and e.get("name") == "commit_layer"),
                    "errors": [ln.get("msg") for ln in lines
                               if ln.get("level") == "error"][:3]}

        def round_(r: int) -> list[dict]:
            def one(j):
                row = routed(ctxs[j], f"fleet/app{j}:r{r}",
                             FLEET_TENANTS[j % 2],
                             os.path.join(work, f"fleet-root{j}-r{r}"))
                check(row["code"] == 0, f"round {r} context {j} exited "
                      f"{row['code']} on {row['worker']}: {row['errors']}")
                return {"context": j, **row}

            t = time.perf_counter()
            with ThreadPoolExecutor(FLEET_CONTEXTS) as pool:
                rows = list(pool.map(one, range(FLEET_CONTEXTS)))
            for row in rows:
                row["digests"] = [d["digest"] for d in image_layers(
                    storages[row["worker"]],
                    f"fleet/app{row['context']}:r{r}")[0]]
            tally: dict = {}
            reasons: dict = {}
            for row in rows:
                tally[row["verdict"]] = tally.get(row["verdict"], 0) + 1
                reasons[row["reason"]] = reasons.get(row["reason"], 0) + 1
            out[f"round{r}"] = {
                "wall_s": time.perf_counter() - t, "verdicts": tally,
                "reasons": reasons,
                "workers": [row["worker"] for row in rows],
                "quota_wait_s": [row["quota_wait_s"] for row in rows],
                "commits": [row["commits"] for row in rows]}
            return rows

        # (t) cold: each context on its ring owner, or on the least
        # loaded worker where the owner held the default spillover
        # depth's builds already.
        r0 = round_(0)
        check(all(row["verdict"] == "spillover" and (
            (row["worker"] == owner and row["reason"] == "placed")
            or row["reason"] == "overloaded")
            for row, owner in zip(r0, owners)),
            f"(t) routed to {[(r['worker'], r['reason']) for r in r0]}, the "
            f"ring owners are {owners}")
        check(all(row["commits"] == 1 and len(row["digests"]) == 1
                  for row in r0),
              f"(t) layer commits {[row['commits'] for row in r0]}")
        emit({"phase": "fleet", "step": "t_cold", **out["round0"]})
        # (u) 1% of each context's files edited: affinity, one dirty layer.
        out["edited_files"] = [append_to_one_percent(np, c, 70 + j)
                               for j, c in enumerate(ctxs)]
        r1 = round_(1)
        check(all(row["verdict"] == "affinity" for row in r1)
              and [row["worker"] for row in r1]
              == [row["worker"] for row in r0],
              f"(u) verdicts {[(row['worker'], row['verdict']) for row in r1]}")
        check(all(row["commits"] == 1 and len(row["digests"]) == 1
                  for row in r1)
              and all(a["digests"] != b["digests"]
                      for a, b in zip(r0, r1)),
              f"(u) layer commits {[row['commits'] for row in r1]}")
        # G1 and S1 on the workers so far: every layer each holds against
        # hashlib and the plain cuts; its G1 launches the 4 MiB blocks of
        # the layers it committed (its routed builds' and its canary's,
        # whose first sweep is waited for: later sweeps hit its KV), its
        # S1 launches its hash batches, one ring pass per layer.
        t = time.perf_counter()
        deadline = time.monotonic() + 60
        while not all((client.alerts().get("canary") or {}).get(
                "workers", {}).get(w, {}).get("total", 0) >= 1 for w in ids):
            check(time.monotonic() < deadline, "no canary on every worker")
            time.sleep(0.5)
        shared = shared_layer_entries(kv)
        held = {}
        for w in ids:
            hz = WorkerClient(socks[w]).healthz()["device"]["kernel_launches"]
            got = {k: v - base[w][k] for k, v in hz.items()}
            page = WorkerClient(socks[w]).metrics()
            layers, canary = fleet_layer_checks(torch, np, dev, storages[w],
                                                shared)
            mine = {row["digests"][0] for row in r0 + r1
                    if row["worker"] == w} | canary
            check(mine <= set(layers), f"{w}: layers {sorted(mine)} not all "
                  "in its storage")
            blocks = sum(-(-layers[d]["bytes"] // BLOCK) for d in mine)
            batches = prom_sum(page, metrics.HASH_BATCHES)
            passes = prom_sum(page, metrics.HASH_BATCH_FILL + "_sum")
            check(got["gear_bitmap"] == blocks,
                  f"{w}: G1 launches {got['gear_bitmap']} != 4 MiB blocks "
                  f"{blocks} of the {len(mine)} layers it committed")
            check(got["sha256_spans"] == 0 and got["sha256_multi"] == batches
                  and passes == len(mine),
                  f"{w}: {got} launches, {batches} batches for {passes} "
                  f"passes of {len(mine)} layer commits")
            held[w] = {"layers": len(layers), "committed": len(mine),
                       "canary_layers": len(canary), "blocks": blocks,
                       "launches": got}
        out["round1"]["held"] = held
        out["round1"]["checks_s"] = time.perf_counter() - t
        emit({"phase": "fleet", "step": "u_edit", **out["round1"]})
        # (v) drain context 0's holder; SIGKILL a second worker (one
        # holding contexts where one does) while a build runs on it. The
        # third, drained for the moment, is where that build fails over.
        drained = r1[0]["worker"]
        t = time.perf_counter()
        answer = post_json(front_sock, "/drain", {"worker": drained})
        others = [w for w in ids if w != drained]
        holders = {row["worker"] for row in r1}
        killed = ([w for w in others if w in holders] or others)[0]
        [survivor] = [w for w in others if w != killed]
        fo_ctx = os.path.join(work, "fleet-failover")
        os.makedirs(fo_ctx)
        with open(os.path.join(fo_ctx, "Dockerfile"), "w") as f:
            f.write(FLEET_FAILOVER_DOCKERFILE)
        write_context(np, fo_ctx, FLEET_FAILOVER_BYTES, FLEET_FAILOVER_SEED)
        post_json(front_sock, "/drain", {"worker": survivor})
        box: dict = {}
        submitter = threading.Thread(target=lambda: box.update(routed(
            fo_ctx, "fleet/failover:1", FLEET_TENANTS[0],
            os.path.join(work, "fleet-root-failover"), "--modifyfs")))
        submitter.start()
        deadline = time.monotonic() + 60
        while not any(b.state == "running" for b in WorkerClient(
                socks[killed]).builds().inflight):
            check(time.monotonic() < deadline and submitter.is_alive(),
                  f"(v) the failover build never ran on {killed}: {box}")
            time.sleep(0.05)
        post_json(front_sock, "/drain", {"worker": survivor, "undrain": True})
        before_kill = WorkerClient(socks[killed]).healthz()["device"][
            "kernel_launches"]
        workers[killed].send_signal(signal.SIGKILL)
        workers[killed].wait(timeout=30)
        submitter.join(timeout=120)
        check(not submitter.is_alive() and box.get("code") == 0
              and box["worker"] == survivor and box["verdict"] == "failover"
              and box["attempts"] >= 2,
              f"(v) the build killed on {killed} mid-build: {box}")
        box["digests"] = [d["digest"] for d in image_layers(
            storages[survivor], "fleet/failover:1")[0]]
        out["disruption"] = {"drained": drained, "killed": killed,
                             "sessions_snapshotted":
                                 answer.get("sessions_snapshotted", 0),
                             "failover": {k: box[k] for k in (
                                 "worker", "verdict", "reason", "attempts",
                                 "elapsed_s", "commits")},
                             "wall_s": time.perf_counter() - t}
        emit({"phase": "fleet", "step": "v_disruption", **out["disruption"]})
        # (w) unchanged rebuilds: displaced contexts move, every layer
        # equals (u)'s and a worker-less oracle's.
        alive = [w for w in ids if w != killed]
        page0 = {w: WorkerClient(socks[w]).metrics() for w in alive}
        # The oracle: each context built by a ``build --hasher gpu``
        # process of its own, without worker or front door, beside (w).
        t = time.perf_counter()
        for j, ctx in enumerate([*ctxs, fo_ctx]):
            root = os.path.join(work, f"fleet-oroot{j}")
            os.makedirs(root)
            oracles.append(start_cli_process(
                work, f"fleet-oracle{j}", "build", ctx, "-t",
                f"fleet/app{j}:oracle", "--hasher", "gpu", "--storage",
                os.path.join(work, f"fleet-oracle{j}"), "--root", root,
                *(["--modifyfs"] if ctx == fo_ctx else [])))
        r2 = round_(2)
        for a, b in zip(r1, r2):
            check(a["digests"] == b["digests"],
                  f"(w) context {a['context']}: digests moved")
            if a["worker"] in (drained, killed):
                check(b["worker"] not in (drained, killed)
                      and b["verdict"] in ("spillover", "failover"),
                      f"(w) context {a['context']} of {a['worker']} went to "
                      f"{b['worker']} ({b['verdict']})")
            else:
                check(b["worker"] == a["worker"]
                      and b["verdict"] == "affinity",
                      f"(w) context {a['context']} left {a['worker']} for "
                      f"{b['worker']} ({b['verdict']})")
        stats = client.healthz()["fleet"]
        peer_hits = {w: prom_sum(WorkerClient(socks[w]).metrics(),
                                 "makisu_fleet_peer_chunk_hits_total")
                     - prom_sum(page0[w],
                                "makisu_fleet_peer_chunk_hits_total")
                     for w in alive}
        prewarms = stats["route_totals"].get("prewarm", 0)
        check(sum(peer_hits.values()) > 0 or prewarms > 0,
              f"(w) no peer chunk hit ({peer_hits}) and no prewarm")
        for j, proc in enumerate(oracles):
            rc = proc.wait(timeout=300)
            check(rc == 0, f"(w) the oracle build of context {j} exited {rc}")
            got = [d["digest"] for d in image_layers(
                os.path.join(work, f"fleet-oracle{j}"),
                f"fleet/app{j}:oracle")[0]]
            check(got == [*r2, box][j]["digests"], f"(w) context {j}: the "
                  f"fleet's layers differ from a worker-less build's")
        # Every layer in every worker's storage (the killed one's too)
        # against hashlib and the plain cuts; each routed build's layers
        # among them (a prewarmed build's blob stays with the worker that
        # committed it).
        t1 = time.perf_counter()
        shared = shared_layer_entries(kv)
        checked = {w: fleet_layer_checks(torch, np, dev, storages[w],
                                         shared)[0] for w in ids}
        everywhere = set().union(*checked.values())
        for row in r0 + r1 + r2 + [box]:
            check(set(row["digests"]) <= everywhere,
                  f"(w) {row['worker']}'s layers {row['digests']} were not "
                  "all checked")
        out["round2"]["layers_checked"] = {w: len(v)
                                           for w, v in checked.items()}
        out["round2"]["checks_s"] = time.perf_counter() - t1
        # The canaries: at least one per alive worker, built on the card.
        deadline = time.monotonic() + 60
        while True:
            canary = client.alerts().get("canary") or {}
            rows = canary.get("workers") or {}
            if all(rows.get(w, {}).get("total", 0) >= 1 for w in alive):
                break
            check(time.monotonic() < deadline,
                  f"no canary on every alive worker: {rows}")
            time.sleep(0.5)
        launches = {w: {k: v - base[w][k] for k, v in WorkerClient(
            socks[w]).healthz()["device"]["kernel_launches"].items()}
            for w in alive}
        launches[killed] = {k: v - base[killed][k]
                            for k, v in before_kill.items()}
        out["round2"].update({
            "peer_chunk_hits": peer_hits, "prewarms": prewarms,
            "route_totals": stats["route_totals"],
            "oracles_s": time.perf_counter() - t,
            "launches_per_worker": launches,
            "canary": {w: {k: row.get(k) for k in
                           ("ok", "score", "total", "latency_seconds")}
                       for w, row in sorted(rows.items())}})
        out["launches"] = {k: sum(v[k] for v in launches.values())
                           for k in base[ids[0]]}
        emit({"phase": "fleet", "step": "w_rebuild", **out["round2"]})
        # (x) the readers as processes; the front door's artifacts.
        t = time.perf_counter()
        rc, text, _ = cli_run(["top", "--socket", front_sock, "--once"])
        rows_top = [ln for ln in text.splitlines()
                    if re.match(r"^w\d+ ", ln)]
        check(rc == 0 and len(rows_top) == FLEET_WORKERS,
              f"top exited {rc} with {len(rows_top)} worker rows: "
              f"{text[-1500:]}")
        rc, text, _ = cli_run(["doctor", "--fleet", front_sock])
        check(rc == 0 and f"worker {killed} is DEAD" in text,
              f"doctor --fleet exited {rc}: {text[-1500:]}")
        rc, alerts_text, _ = cli_run(["alerts", front_sock])
        check(rc == 0 and "fleet alerts" in alerts_text,
              f"alerts exited {rc}: {alerts_text[-1500:]}")
        rc, prof_text, _ = cli_run(["profile", "--fleet", front_sock,
                                    "--seconds", "1"])
        check(rc == 0, f"profile --fleet exited {rc}: {prof_text[-1500:]}")
        client.exit()
        rc = front.wait(timeout=60)
        check(rc == 0, f"the front door exited {rc} after /exit")
        rc, report_text, _ = cli_run(["report", "--fleet", events_path])
        check(rc == 0 and "fleet trace report" in report_text,
              f"report --fleet exited {rc}: {report_text[-1500:]}")
        with open(trace_path) as f:
            trace = json.load(f)
        routed = {row["trace_id"] for row in r0 + r1 + r2}
        roots = [e["args"]["trace_id"] for e in trace["traceEvents"]
                 if e.get("name") == "fleet_build" and e.get("ph") == "X"]
        check(len(roots) == len(set(roots)) == 3 * FLEET_CONTEXTS + 1
              and set(roots) == routed | {box["trace_id"]},
              f"the merged trace holds {len(roots)} fleet_build spans "
              f"({len(set(roots))} trace ids) for {len(routed)} builds")
        out["readers"] = {"wall_s": time.perf_counter() - t,
                          "top_rows": rows_top,
                          "alerts": alerts_text.strip().splitlines()[:6],
                          "report_lines": len(report_text.splitlines()),
                          "trace_ids": len(set(roots))}
        emit({"phase": "fleet", "step": "x_readers", **out["readers"]})
        for w in alive:
            WorkerClient(socks[w]).exit()
            rc = workers[w].wait(timeout=60)
            check(rc == 0, f"worker {w} exited {rc} after /exit")
        # (y) the reference harness, at its own template sizes.
        rc = loadgen.wait(timeout=600)
        out["loadgen_done_s"] = time.perf_counter() - t0
        with open(os.path.join(work, "fleet-loadgen.err")) as f:
            err = f.read()[-2000:]
        check(rc == 0, f"loadgen --fleet exited {rc}: {err}")
    finally:
        for proc in [front, loadgen, *workers.values(), *oracles]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        kv.stop()
    with open(loadgen_report) as f:
        report = json.load(f)
    fleet = report["fleet"]
    check(fleet["digest_identity"] and not fleet["digest_mismatches"]
          and fleet["disruption"]["killed"]
          and fleet["relocated_builds"] + fleet["failover_builds"] >= 1,
          f"loadgen --fleet: identity {fleet['digest_identity']}, "
          f"disruption {fleet['disruption']}, relocated "
          f"{fleet['relocated_builds']}, failovers "
          f"{fleet['failover_builds']}")
    out["loadgen"] = {
        "wall_s": report["wall_seconds"],
        "baseline_wall_s": fleet["baseline"]["wall_seconds"],
        "builds": report["builds"], "failures": report["failures"],
        "distribution": fleet["distribution"],
        "route_totals": fleet["route_totals"],
        "disruption": fleet["disruption"],
        "relocated_builds": fleet["relocated_builds"],
        "failover_builds": fleet["failover_builds"],
        "peer_chunk_hits": fleet["peer_chunk_hits"],
        "p99_s": fleet["p99_seconds"],
        "baseline_p99_s": fleet["baseline_p99_seconds"]}
    emit({"phase": "fleet", "step": "y_loadgen", **out["loadgen"]})
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 15: the sharded hash step over torch.distributed ------------------

PARALLEL_RANKS = 4  # ranks sharing the card over gloo: meshes (2, 2), (1, 4)
HALO_SHARD = (2, 2 * MIB)  # the production shard of a (1, 2) mesh, 2 rows


def halo_shard(torch, np, dev):
    """Seeded bytes of the production shard and its halo on ``dev``."""
    rng = np.random.default_rng(16)
    rows, n = HALO_SHARD
    return tuple(torch.from_numpy(rng.integers(
        0, 256, size=(rows, k), dtype=np.uint8)).to(dev) for k in (n, 32))


def check_gear_halo(torch, np, dev, int_rate, cupti_ms: float) -> dict:
    """G1's halo entry against its plain version (``gear_bitmap_with_halo``
    over the halo's G-values) and against the unsharded stream's bitmap,
    at lengths that end mid-tile and at the production shard.
    ``cupti_ms``: its median CUPTI duration at the production shard +
    halo, from phase 4's multi-buffer process (a second profiler session
    in one process kept none of 9 launches, measured on one H100)."""
    from makisu_tpu_torch.ops import backend, gear, gear_cuda

    rng = np.random.default_rng(15)
    words = mismatches = max_err = 0
    for n in (32, 3 * 16384 + 96, HALO_SHARD[1]):
        for rows in (1, HALO_SHARD[0]):
            full = torch.from_numpy(rng.integers(
                0, 256, size=(rows, n + 64), dtype=np.uint8)).to(dev)
            x, h = full[:, 64:].contiguous(), full[:, 32:64].contiguous()
            for avg_bits in (gear.DEFAULT_AVG_BITS, 4, 1):
                got = gear_cuda.gear_bitmap(x, avg_bits, halo=h).cpu()
                a = got.numpy().astype(np.int64)
                for want in (gear.gear_bitmap_with_halo(
                                 x, gear.halo_values(h), avg_bits),
                             gear.gear_bitmap(full, avg_bits)[:, 2:]):
                    b = want.cpu().numpy().astype(np.int64)
                    words += a.size
                    mismatches += int((a != b).sum())
                    max_err = max(max_err, int(np.abs(a - b).max()))
    check(mismatches == 0, f"gear kernel, halo entry: {mismatches} of "
          f"{words} bitmap words differ from the plain version or the "
          "unsharded stream")
    x, h = halo_shard(torch, np, dev)
    rows, n = HALO_SHARD
    plain_ms = backend.time_cuda_ms(
        lambda: gear.gear_bitmap_with_halo(x, gear.halo_values(h)), reps=5,
        warmup=1)
    alu, either = GEAR_OPS_PER_BYTE
    bound_ms, bound_by = bound(rows * (n + 32 + n / 8), alu * rows * n,
                               either * rows * n, int_rate)
    return {"name": "gear_bitmap_halo", "route": "cuda",
            "source": "makisu_tpu_torch/csrc/gear.cu",
            "replaces": "makisu_tpu/ops/gear_pallas.py:283",
            "computes": "makisu_tpu/ops/gear.py:221 gear_bitmap_with_halo",
            "shape": [rows, n], "halo": [rows, 32], "words_checked": words,
            "mismatches": mismatches, "max_abs_err": max_err,
            "ms": cupti_ms, "ms_from": "cupti, median of 9 launches in "
            "phase 4's multi-buffer process",
            "event_pair_ms": queued_event_ms(
                torch, lambda: gear_cuda.gear_bitmap(x, halo=h), 50),
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / cupti_ms,
            "library_ms": None}


def step_launches(cases: list[dict]) -> dict:
    """Launches of the sharded steps alone, summed over every rank and
    step of ``cases`` (the dry run counts them around each step)."""
    out = {"gear_bitmap": 0, "gear_bitmap_halo": 0, "sha256_lanes": 0}
    for case in cases:
        for rank in case["ranks"]:
            for key in out:
                out[key] += sum(rank["launches"][key])
    return out


def check_cases(cases: list[dict]) -> None:
    for case in cases:
        check(not any(case["mismatches"].values()),
              f"{case['label']}: {case['mismatches']}")
        for rank in case["ranks"]:
            want = {"gear_bitmap": [1, 1], "sha256_lanes": [1, 1],
                    "gear_bitmap_halo": [int(rank["coord"][1] > 0)] * 2}
            check(rank["launches"] == want,
                  f"{case['label']} rank {rank['rank']}: launches per "
                  f"step {rank['launches']}, want {want}")


def parallel_phase(torch, np, dev, int_rate, work: str,
                   halo_cupti_ms: float) -> dict:
    """G1's halo entry against its plain version (``check_gear_halo``);
    (a) a (1, 1) mesh over a one-rank NCCL group in this process at the
    production shape; (b) the dry run's 4 rank processes sharing the
    card over gloo, meshes (2, 2) and (1, 4), the reference's two shapes
    on each and (c) SnapshotHasher's default lanes on (2, 2). Every
    gathered bitmap and digest against the single-card forward, the
    plain versions and hashlib (in rank 0), one G1 and one lane-S1
    launch per rank and step, the halo entry on every shard past seq
    index 0, no bytes left on the card and no rank left alive."""
    import torch.distributed as dist

    from makisu_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    held_before = torch.cuda.memory_allocated(dev)
    halo = check_gear_halo(torch, np, dev, int_rate, halo_cupti_ms)
    halo_s = time.perf_counter() - t0
    emit({"phase": "parallel", "step": "halo_kernel", "seconds": halo_s,
          **{k: v for k, v in halo.items() if k != "name"}})

    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke-nccl-") as rv:
        dist.init_process_group("nccl", init_method=f"file://{rv}/rv",
                                world_size=1, rank=0)
        try:
            one = dryrun.run_cases([dryrun.make_case("production", 1)],
                                   "cuda")
        finally:
            dist.destroy_process_group()
    nccl_s = time.perf_counter() - t
    check_cases(one)
    emit({"phase": "parallel", "step": "a_nccl_1x1", "seconds": nccl_s,
          "ranks": one[0]["ranks"], "mismatches": one[0]["mismatches"]})

    out = os.path.join(work, "parallel")
    os.makedirs(out)
    cases = [dryrun.make_case(shape, PARALLEL_RANKS, 2)
             for shape in ("tiny", "production", "hasher_default")] + \
        [dryrun.make_case(shape, PARALLEL_RANKS, PARALLEL_RANKS)
         for shape in ("tiny", "production")]
    t = time.perf_counter()
    rc = dryrun.spawn(PARALLEL_RANKS, cases, "cuda", "gloo", out,
                      timeout=300)
    spawn_s = time.perf_counter() - t
    left = live_descendants()
    check(rc == 0, f"the dry run failed (rc {rc})")
    check(not left, f"rank processes outlived the dry run: {left}")
    with open(os.path.join(out, "report.json")) as f:
        report = json.load(f)
    check(report["backend"] == "gloo" and report["world"] == PARALLEL_RANKS,
          f"dry run report {report['backend']} x {report['world']}")
    check([c["label"] for c in report["cases"]]
          == [c["label"] for c in cases], "the dry run skipped a case")
    check_cases(report["cases"])
    card = nvidia_smi("name,power.limit")
    for case in report["cases"]:
        emit({"phase": "parallel", "step": f"b_gloo_{case['label']}",
              "card": card, "seconds": case["seconds"],
              "check_s": case["check_s"],
              "step_ms_by_rank": {str(r["rank"]): r["step_ms"]
                                  for r in case["ranks"]},
              "timer": case["ranks"][0]["timer"],
              "mismatches": case["mismatches"]})
    held_after = torch.cuda.memory_allocated(dev)
    check(held_after == held_before, f"the phase left "
          f"{held_after - held_before} bytes on the card ({held_before} "
          "before it)")
    launches = step_launches(one + report["cases"])
    halo["launches"] = launches["gear_bitmap_halo"]
    return {"phase": "parallel", "card": card, "halo_s": halo_s,
            "nccl_s": nccl_s, "spawn_s": spawn_s,
            "held_bytes_before": held_before, "held_bytes_after": held_after,
            "launches": launches, "halo_row": halo,
            "seconds": time.perf_counter() - t0}


# -- phase 16: the bounded device plane --------------------------------------

PLANE_SEEDS = (71,)  # (a)'s context: config-3 shaped, 4 MiB (phase 11's)
PLANE_SLEEP_S = 2.0  # (b)'s stand-in for a hung kernel
PLANE_SYNC_TIMEOUT = "0.5"  # (b)'s session: MAKISU_TPU_SYNC_TIMEOUT
PLANE_GRACE = "10"  # (c)'s second process: MAKISU_TPU_PROBE_GRACE


def probe_child_main(mode: str, work: str) -> int:
    """``chip_smoke.py --probe-child MODE WORK``: one process of phase 16
    that runs the device plane's probe as a build's first session would
    (``backend.backend_ready()``, the card its target) and prints one
    JSON line: its summary, its seconds, the probe's snapshot and the
    kernels' launch counts after it. MODE ``wedge`` first parks
    ``_phase_context_init`` on an event that never fires (a card that
    never answers context creation); ``after`` waits for the wedge cache
    (the first process's verdict) and then runs the probe as it is;
    ``cold`` points the kernels' build directory at an empty one under
    WORK, so the probe's ``kernel_build`` runs nvcc."""
    started = time.time()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pathlib

    from makisu_tpu_torch.ops import _build, backend, gear_cuda, sha256_cuda
    imported = time.time()
    if mode == "wedge":
        never = threading.Event()

        def parked_context_init(ctx):
            never.wait()

        backend._phase_context_init = parked_context_init
    elif mode == "cold":
        _build.BUILD_DIR = pathlib.Path(work) / "cold-kernels"
    elif mode == "after":
        deadline = time.monotonic() + 120
        while not os.path.exists(backend._cache_path()):
            check(time.monotonic() < deadline, "no wedge verdict to follow")
            time.sleep(0.02)
    verdict_wait_s = time.time() - imported
    t0 = time.monotonic()
    summary = backend.backend_ready()
    ready_s = time.monotonic() - t0
    recorded = backend.wait_for_probe_record(30)
    snap = backend.probe_snapshot()
    print(json.dumps({
        "mode": mode, "pid": os.getpid(), "summary": summary,
        "started": started, "import_s": imported - started,
        "verdict_wait_s": verdict_wait_s,
        "ready_s": ready_s, "recorded": recorded,
        "snapshot": {k: snap.get(k) for k in (
            "state", "phase", "phase_reached", "phases", "sample_count",
            "deepest_frame", "detail")},
        "launches": {"gear_bitmap": gear_cuda.launches,
                     "sha256_spans": sha256_cuda.launches},
        "libraries": sorted(p.name for p in _build.BUILD_DIR.glob("*.so")),
        "cache_exists": os.path.exists(backend._cache_path())}),
        flush=True)
    return 0


def start_probe_child(mode: str, work: str, env: dict):
    """A ``--probe-child`` process; its JSON line comes back through
    ``finish_probe_child``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--probe-child", mode,
         work], cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, **env})


def finish_probe_child(proc, seconds: float = 120) -> dict:
    out, err = proc.communicate(timeout=seconds)
    check(proc.returncode == 0,
          f"probe child {proc.args[-2]} exited {proc.returncode}: "
          f"{err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def plane_env(work: str, name: str) -> dict:
    """Phase 16's ledger and wedge cache for one part: temporary, never
    the checkout's."""
    return {"MAKISU_TPU_DEVICE_SESSIONS_DIR":
                os.path.join(work, f"sessions-{name}"),
            "MAKISU_TPU_PROBE_CACHE": os.path.join(work, f"wedge-{name}.json")}


def ledger_of(work: str, name: str) -> list[dict]:
    from makisu_tpu_torch.utils import deviceprobe
    return deviceprobe.read_records(os.path.join(work, f"sessions-{name}"))


def check_ok_record(rec: dict, what: str) -> dict:
    """One ``ok`` ledger record with every phase ok and timed; returns
    the phases' seconds."""
    from makisu_tpu_torch.ops import backend
    phases = rec.get("phases") or []
    check(rec.get("verdict") == "ok" and rec.get("platform") == "cuda"
          and [p["phase"] for p in phases] == list(backend.PROBE_PHASES)
          and all(p["ok"] and p["seconds"] >= 0 for p in phases),
          f"{what}: not an ok record of five timed phases: {rec}")
    return {p["phase"]: p["seconds"] for p in phases}


def bound_on_the_card(torch, np, dev) -> dict:
    """(b): a session's stream held by ``torch.cuda._sleep`` (a stand-in
    for a hung kernel). ``sync_bounded`` on an event behind it raises
    within 1 s of its 0.25 s bound; a ``ChunkSession`` fed three blocks
    under ``MAKISU_TPU_SYNC_TIMEOUT`` raises naming the gear bitmap
    readback and keeps no ring; once the sleep drains, G1 on that stream
    is bit-exact and the card's allocated bytes are back where they were
    before the session."""
    from makisu_tpu_torch.chunker.cdc import BLOCK, ChunkSession
    from makisu_tpu_torch.ops import backend, gear, gear_cuda

    out = {}
    held_before = torch.cuda.memory_allocated(dev)
    gear_before = gear_cuda.launches
    session = ChunkSession(device=dev)
    stream = session._stream
    cycles = int(PLANE_SLEEP_S * max_sm_hz())
    with torch.cuda.stream(stream):
        torch.cuda._sleep(cycles)
        blocked = torch.cuda.Event()
        blocked.record()
    t0 = time.monotonic()
    try:
        backend.sync_bounded(blocked, "smoke", timeout=0.25)
        raised = ""
    except TimeoutError as e:
        raised = str(e)
    out["sync_bounded_raise_s"] = time.monotonic() - t0
    check(raised.startswith("smoke did not complete within 0.25s")
          and out["sync_bounded_raise_s"] < 1.0,
          f"sync_bounded behind a {PLANE_SLEEP_S} s kernel: {raised!r} "
          f"after {out['sync_bounded_raise_s']:.3f} s")
    data = np.random.default_rng(72).integers(
        0, 256, 3 * BLOCK, dtype=np.uint8).tobytes()
    os.environ["MAKISU_TPU_SYNC_TIMEOUT"] = PLANE_SYNC_TIMEOUT
    t0 = time.monotonic()
    try:
        session.update(data)
        raised = ""
    except TimeoutError as e:
        raised = str(e)
    finally:
        del os.environ["MAKISU_TPU_SYNC_TIMEOUT"]
    out["session_raise_s"] = time.monotonic() - t0
    check(raised.startswith("gear bitmap readback did not complete within "
                            f"{PLANE_SYNC_TIMEOUT}s"),
          f"the blocked session raised {raised!r}")
    check(session._ring is None and not session._inflight
          and not session._free, "the raised session still holds its ring "
          "or pinned blocks")
    out["session_launches"] = gear_cuda.launches - gear_before
    del session
    # The sleep drains; then G1 on the same stream, held against its
    # plain version.
    with torch.cuda.stream(stream):
        drained = torch.cuda.Event()
        drained.record()
        backend.sync_bounded(drained, "the sleep", timeout=30)
        out["drain_s"] = time.monotonic() - t0
        x = torch.from_numpy(np.frombuffer(data[:BLOCK], np.uint8).copy())
        x = x.pin_memory().to(dev, non_blocking=True)
        got = gear_cuda.gear_bitmap(x)
        want = gear.gear_bitmap(x)
        same = torch.equal(got, want)
    check(same, "G1 after the drained sleep differs from its plain version")
    out["launches"] = gear_cuda.launches - gear_before
    del x, got, want
    held_after = torch.cuda.memory_allocated(dev)
    check(held_after == held_before, f"the card holds {held_after} bytes "
          f"after the raised session, {held_before} before it")
    out["held_bytes"] = held_after
    return out


def start_plane_context(root: str):
    """(a)'s context, written under ``root`` by a process of this script
    started before phase 15, so phase 16 does not wait for it."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--contexts", "plane",
         root, "0", "1"], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)


def device_plane_phase(torch, np, dev, work: str, writer,
                       ctx_root: str) -> dict:
    """Phase 16: the bounded device plane. (a) a ``build --hasher gpu``
    process on a 4 MiB config-3 context whose ledger gets one ``ok``
    record of five timed phases, ``doctor --device`` naming it, and the
    layer's chunks and cuts right; (b) ``bound_on_the_card``; (c) a
    process whose context creation never returns (a patched phase) gets
    the wedge summary within 2 s, a ``wedged`` record naming
    ``context_init`` with samples, and the wedge cache; a second,
    unpatched process gets past the cache within its grace and clears
    it. Beside them a process whose probe builds the kernels cold times
    ``kernel_build`` with nvcc. ``writer`` is ``start_plane_context``'s
    process for (a)'s context under ``ctx_root``."""
    t0 = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    out = {"phase": "device_plane", "card": card}
    procs: list = [writer]
    try:
        return _device_plane(torch, np, dev, work, writer, ctx_root, t0,
                             card, out, procs)
    finally:
        for proc in procs:  # a check failed while some still ran
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _device_plane(torch, np, dev, work: str, writer, ctx_root: str,
                  t0: float, card: str, out: dict, procs: list) -> dict:
    # Every process starts at once: each takes seconds to import torch.
    # The second (c) process waits for the first one's wedge verdict.
    wedge = start_probe_child("wedge", work, {
        **plane_env(work, "c"), "MAKISU_TPU_PROBE_TIMEOUT": "1",
        "MAKISU_TPU_PROBE_SAMPLE_INTERVAL": "0.05"})
    after = start_probe_child("after", work, {
        **plane_env(work, "c"), "MAKISU_TPU_PROBE_GRACE": PLANE_GRACE})
    cold = start_probe_child("cold", work, plane_env(work, "cold"))
    procs += [wedge, after, cold]

    _, err = writer.communicate()
    check(writer.returncode == 0, f"writing (a)'s context failed: {err}")
    ctx = context_path(ctx_root, "plane", 0)
    storage = os.path.join(work, "plane-storage")
    os.makedirs(os.path.join(work, "plane-root"))
    t = time.perf_counter()
    started = time.time()
    build = start_cli_process(
        work, "plane-build", "build", ctx, "-t", "plane/app:1", "--hasher",
        "gpu", "--storage", storage, "--root",
        os.path.join(work, "plane-root"), env=plane_env(work, "a"))
    procs.append(build)

    bound = bound_on_the_card(torch, np, dev)
    emit({"phase": "device_plane", "step": "b_bound", "card": card,
          **bound})

    wedged = finish_probe_child(wedge)
    check(wedged["summary"] is not None
          and "did not complete within 1s" in wedged["summary"]
          and wedged["ready_s"] < 2.0 and wedged["recorded"]
          and wedged["snapshot"]["state"] == "wedged"
          and wedged["snapshot"]["phase"] == "context_init"
          and wedged["cache_exists"],
          f"(c) the wedged process: {wedged}")
    [rec] = ledger_of(work, "c")
    check(rec["verdict"] == "wedged" and rec["wedged_phase"] == "context_init"
          and rec["phase_reached"] == "driver_discovery" and rec["samples"]
          and sum(s["count"] for s in rec["samples"]) >= 3,
          f"(c) the wedge record: {rec}")
    emit({"phase": "device_plane", "step": "c_wedge", "card": card,
          "import_s": wedged["import_s"], "ready_s": wedged["ready_s"],
          "summary": wedged["summary"],
          "samples": sum(s["count"] for s in rec["samples"]),
          "frame": rec["samples"][-1]["frame"]})

    later = finish_probe_child(after)
    check(later["summary"] is None
          and later["ready_s"] < float(PLANE_GRACE)
          and later["snapshot"]["state"] == "ok"
          and not later["cache_exists"]
          and not os.path.exists(
              plane_env(work, "c")["MAKISU_TPU_PROBE_CACHE"]),
          f"(c) the second process: {later}")
    records_c = ledger_of(work, "c")
    check([r["verdict"] for r in records_c] == ["wedged", "ok"]
          and records_c[1]["pid"] == later["pid"],
          f"(c) ledger verdicts {[r['verdict'] for r in records_c]}")
    after_s = check_ok_record(records_c[1], "(c) the second process")
    doc_rc, doc, _ = cli_run(["doctor", "--device",
                              os.path.join(work, "sessions-c")])
    check(doc_rc == 0 and "dominant wedge: phase 'context_init'" in doc
          and "last healthy:" in doc,
          f"(c) doctor --device exited {doc_rc}: {doc}")
    emit({"phase": "device_plane", "step": "c_after", "card": card,
          "import_s": later["import_s"], "ready_s": later["ready_s"],
          "probe_phase_s": after_s,
          "launches": later["launches"]})

    coldly = finish_probe_child(cold)
    check(coldly["summary"] is None and coldly["snapshot"]["state"] == "ok"
          and len(coldly["libraries"]) == 2,
          f"the cold probe: {coldly}")
    [rec] = ledger_of(work, "cold")
    cold_s = check_ok_record(rec, "the cold probe")
    emit({"phase": "device_plane", "step": "cold_kernel_build",
          "card": card, "import_s": coldly["import_s"],
          "ready_s": coldly["ready_s"],
          "probe_phase_s": cold_s, "libraries": coldly["libraries"],
          "launches": coldly["launches"]})

    rc = build.wait(timeout=300)
    build_s = time.perf_counter() - t
    with open(os.path.join(work, "plane-build.log")) as f:
        records = [json.loads(line) for line in f]
    check(rc == 0, f"(a) the build exited {rc}: "
          f"{[r['msg'] for r in records if r['level'] == 'error']}")
    # (c) and the cold probe checked while (a) runs; now (a).
    [rec] = ledger_of(work, "a")
    phase_s = check_ok_record(rec, "(a) the build's probe")
    check(rec["source"] == "build", f"(a) record source {rec['source']}")
    doc_rc, doc, doc_s = cli_run(["doctor", "--device",
                                  os.path.join(work, "sessions-a")])
    check(doc_rc == 0 and "ok×1" in doc and "device route healthy" in doc,
          f"(a) doctor --device exited {doc_rc}: {doc}")
    rows = check_committed_layers(torch, np, dev, storage)
    check(len(rows) == 1, f"(a) {len(rows)} layers committed")
    [commit] = [r for r in records if r["msg"].startswith("committed layer ")]
    # Where the process's seconds went: to its first log line (the
    # interpreter, torch and the CLI), the plan, the commit, the rest.
    first = {}
    for r in records:
        for key in ("stage 1/", "committed layer ", "successfully built"):
            if r["msg"].startswith(key):
                first.setdefault(key, r["ts"])
    emit({"phase": "device_plane", "step": "a_build", "card": card,
          "seconds": build_s, "first_log_s": records[0]["ts"] - started,
          "plan_s": first["stage 1/"] - records[0]["ts"],
          "to_commit_s": first["committed layer "] - first["stage 1/"],
          "built_s": first["successfully built"] - started,
          "commit_s": commit.get("commit_s"),
          "session_s": commit.get("session_s"),
          "probe_total_s": rec["total_seconds"],
          "probe_phase_s": phase_s, "doctor_s": doc_s,
          "gear_blocks": commit.get("gear_blocks"),
          "span_launches": commit.get("span_launches"), "layer": rows[0]})

    out["launches"] = {
        "gear_bitmap": bound["launches"] + later["launches"]["gear_bitmap"]
        + coldly["launches"]["gear_bitmap"],
        "sha256_spans": later["launches"]["sha256_spans"]
        + coldly["launches"]["sha256_spans"]}
    out["bound"] = bound
    out["probe_phase_s"] = {"build": phase_s, "after_wedge": after_s,
                            "cold": cold_s}
    out["wedge_ready_s"] = wedged["ready_s"]
    out["seconds"] = time.perf_counter() - t0
    return out


def clear_dir(path: str) -> None:
    """Remove everything inside ``path``, keeping the directory."""
    for name in os.listdir(path):
        entry = os.path.join(path, name)
        if os.path.isdir(entry):
            shutil.rmtree(entry)
        else:
            os.unlink(entry)


def main() -> int:
    smoke_t0 = time.perf_counter()
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
    # Orphans of the processes this run starts become its children, so
    # the check before the result finds them (PR_SET_CHILD_SUBREAPER).
    import ctypes
    check(ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0,
          "prctl(PR_SET_CHILD_SUBREAPER) failed")
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    int_rate = int32_ops_per_s(torch)

    t0 = time.perf_counter()
    built = _build.build_all()  # the kernels (nvcc) and host libraries (g++)
    ptxas = {}
    for name in _build.SOURCES:
        log = _build.ptxas_log(name)
        print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", log)]
        check(log and not any(spills),
              f"{name}.cu: ptxas reports spills (or no report): {ptxas[name]}")
    from makisu_tpu_torch import native
    check(native.layersink_available() and native.pgzip_available(),
          "the native layer sink and pgzip codec did not load")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "ptxas": ptxas,
          # The Python sink deflates with CPython's zlib, the native one
          # with the zlib it linked: phase native_sink holds their bytes
          # equal.
          "zlib": {"python_runtime": zlib.ZLIB_RUNTIME_VERSION,
                   "native": native.zlib_version()}})

    t0 = time.perf_counter()
    tar, nfiles = make_layer_tar(np, LAYER_BYTES)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ends = plain_cuts(torch, np, tar, dev)
    emit({"phase": "layer", "bytes": len(tar), "files": nfiles,
          "target_bytes": LAYER_BYTES, "make_tar_s": make_s,
          "oracle_s": time.perf_counter() - t0, "chunks": len(ends)})

    work = tempfile.mkdtemp(prefix="smoke-build-")
    tel = tempfile.mkdtemp(prefix="smoke-telemetry-")
    plane_root = tempfile.mkdtemp(prefix="smoke-plane-")
    try:
        # The commit's trace is the process's first profiler session.
        commit = layer_commit(torch, np, dev, tar, ends.tolist(), work)
        emit(commit)
        trace = commit["trace"]
        kernels = [
            check_gear(torch, np, dev, int_rate, trace["gear_ms_median"]),
            check_sha(torch, np, dev, int_rate, tar, ends,
                      trace["sha256_ms_per_launch"][0]),
            sha_multi_process()]
        halo_cupti_ms = kernels[2].pop("gear_halo_cupti_ms")
        check(commit["span_launches"]["per_launch"][0]["spans"]
              == kernels[1]["shape"]["spans"],
              "the commit's first S1 launch hashed other spans than one "
              "ring pass")
        emit({"phase": "kernels", "int32_ops_per_s": int_rate,
              "max_sm_hz": max_sm_hz(), "checked": kernels,
              "launch_errors_per_stream":
                  check_launch_errors_per_stream(torch, np, dev)})
        del tar
        emit(snapshot_hasher(torch, np, dev))
        emit(native_sink_phase(torch, np, dev, work))
        build = build_phase(torch, np, dev, work, tel)
        emit(build)
        registry = registry_phase(torch, np, dev, work)
        clear_dir(work)
        resident = session_phase(torch, np, dev, work)
        emit(resident)
        emit(telemetry_phase(np, work, tel, build))
        wave = worker_phase(torch, np, dev, work)
        emit(wave)
        clear_dir(work)
        # Phases 12 and 13 share the Redis double and the registry:
        # phase 13 builds from the entries phase 12's workers wrote.
        import secrets

        from makisu_tpu_torch.tools.miniregistry import MiniRegistry
        password = "smoke-" + secrets.token_hex(12)
        resp = RespDouble(password)
        reg = MiniRegistry().start()
        try:
            dist = distribution_phase(torch, np, dev, work, resp, reg,
                                      password)
            emit(dist)
            governed = storage_phase(torch, np, dev, work, dist, resp, reg,
                                     password)
            emit(governed)
        finally:
            resp.stop()
            reg.stop()
        clear_dir(work)
        fleet = fleet_phase(torch, np, dev, work)
        emit(fleet)
        clear_dir(work)
        plane_writer = start_plane_context(plane_root)
        par = parallel_phase(torch, np, dev, int_rate, work,
                             halo_cupti_ms)
        emit({k: v for k, v in par.items() if k != "halo_row"})
        kernels.append(par["halo_row"])
        clear_dir(work)
        plane = device_plane_phase(torch, np, dev, work, plane_writer,
                                   plane_root)
        emit(plane)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(tel, ignore_errors=True)
        shutil.rmtree(plane_root, ignore_errors=True)

    for kr in kernels:
        # Each path ran with the counts set to 0 just before it (the
        # worker's: counted in its own process, from its start, less the
        # parity probe's, read from its /healthz; phase 15's: each
        # rank's, around each sharded step).
        if kr["name"] == "gear_bitmap_halo":
            kr["launches_by_path"] = {"parallel": kr["launches"]}
        elif kr["name"] == "sha256_multi":
            kr["launches_by_path"] = {"worker": wave["launches"][kr["name"]]}
            kr["launches"] = kr["launches_by_path"]["worker"]
        else:
            kr["launches"] = commit["launches"][kr["name"]]
            kr["launches_by_path"] = {
                "layer_commit": kr["launches"],
                "build": build["config3"]["launches"][kr["name"]],
                "edit": build["edit"]["launches"][kr["name"]],
                "registry_base": registry["base"]["launches"][kr["name"]],
                "registry_app": registry["app"]["launches"][kr["name"]],
                "session_edit_1_file":
                    resident["edit_1_file"]["launches"][kr["name"]],
                "session_edit_1_percent":
                    resident["edit_1_percent"]["launches"][kr["name"]]}
            if kr["name"] == "gear_bitmap":
                kr["launches_by_path"]["worker"] = \
                    wave["launches"][kr["name"]]
        if kr["name"] in ("gear_bitmap", "sha256_multi"):
            # Worker A's cold build of phase 12 and worker C's budgeted
            # cold build of phase 13 (each its own process, read from its
            # /healthz around the build).
            kr["launches_by_path"]["distribution"] = \
                dist["j_a_v1"]["launches"][kr["name"]]
            kr["launches_by_path"]["storage"] = \
                governed["r_budget_build"]["launches"][kr["name"]]
            # Phase 14's three worker processes, each read from its
            # /healthz after its parity probe and at the phase's end (the
            # killed one just before the kill).
            kr["launches_by_path"]["fleet"] = fleet["launches"][kr["name"]]
        if kr["name"] in ("gear_bitmap", "sha256_spans"):
            # Phase 15's sharded steps (S1's lane entry).
            kr["launches_by_path"]["parallel"] = par["launches"][
                "gear_bitmap" if kr["name"] == "gear_bitmap"
                else "sha256_lanes"]
            # Phase 16: the probes' first dispatch in its processes and
            # (b)'s launches behind and after the blocked stream.
            kr["launches_by_path"]["device_plane"] = \
                plane["launches"][kr["name"]]
        check(min(kr["launches_by_path"].values()) > 0,
              f"{kr['name']} never ran on a main path: "
              f"{kr['launches_by_path']}")
    emit({"kernels": [{k: v for k, v in kr.items() if k != "lane_shapes"}
                      for kr in kernels]})
    left = live_descendants()
    for entry in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(int(entry.split()[0]), signal.SIGKILL)
    check(not left, f"processes started by this run were still alive at "
          f"its end (killed now): {left}")
    emit({"smoke_seconds": time.perf_counter() - smoke_t0})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--contexts"]:
            sys.exit(contexts_main(sys.argv[2], sys.argv[3],
                                   int(sys.argv[4]), int(sys.argv[5])))
        if sys.argv[1:2] == ["--probe-child"]:
            sys.exit(probe_child_main(sys.argv[2], sys.argv[3]))
        sys.exit(sha_multi_main() if sys.argv[1:] == ["--sha-multi"]
                 else main())
    except Exception:  # noqa: BLE001 - report any phase failure and exit 1
        traceback.print_exc()
        sys.exit(1)
