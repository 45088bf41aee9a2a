"""makisu-tpu-torch command line: build / pull / push / diff / version, and
the telemetry readers report / explain / history / profile / doctor.

    python -m makisu_tpu_torch.cli [--metrics-out R] [--trace-out T]
        [--events-out E] [--explain-out L] [--history-out H]
        [--profile-out P] [--diag-out D] [--stall-timeout S]
        [--torch-profile DIR] build CTX -t repo:tag [--hasher gpu|cpu]
        [--push REGISTRY] [--gzip-backend zlib|pgzip|auto]
    python -m makisu_tpu_torch.cli pull REGISTRY/repo:tag [--delta SOCKET]
        [--report-out FILE]
    python -m makisu_tpu_torch.cli push IMAGE.tar -t repo:tag --push REGISTRY
    python -m makisu_tpu_torch.cli diff IMAGE_A IMAGE_B
    python -m makisu_tpu_torch.cli report R [--events E] | report --fleet E
    python -m makisu_tpu_torch.cli explain L [--baseline L0] [--metrics R]
    python -m makisu_tpu_torch.cli history H... | history diff A B
    python -m makisu_tpu_torch.cli profile P | profile diff A B
        | profile --fleet SOCKET [--seconds S]
    python -m makisu_tpu_torch.cli doctor BUNDLE|SOCKET | doctor --fleet SOCKET
    python -m makisu_tpu_torch.cli doctor --storage [DIR|SOCKET] [--repair]
        [--eviction-budget BYTES]
    python -m makisu_tpu_torch.cli du [--storage DIR] [--json]
    python -m makisu_tpu_torch.cli [--hash-linger-ms MS] worker --socket S
        [--max-concurrent-builds N] [--slo-config F] [--alert-webhook URL]
        [--storage-budget MB] [--storage-remote DIR]
    python -m makisu_tpu_torch.cli serve --socket S --storage DIR
    python -m makisu_tpu_torch.cli sessions S [list|snapshot|restore] [CTX]
    python -m makisu_tpu_torch.cli alerts S
    python -m makisu_tpu_torch.cli fleet --socket F --worker S[=STORAGE]...
        [--tenant-quota N] [--canary-interval S] [--canary-hasher gpu|cpu]
    python -m makisu_tpu_torch.cli top --socket S [--once]
    python -m makisu_tpu_torch.cli loadgen [--fleet | --slo-smoke |
        --prewarm-smoke | --evict-soak] [--hasher gpu|cpu] [--report R]
    python -m makisu_tpu_torch.cli check [PATH...] [--json] [--rule NAME]
        [--update-baseline] [--baseline FILE]

Copy of ``makisu_tpu/cli.py``'s ``build``, ``pull``, ``push``, ``diff``,
``version``, ``report``, ``explain``, ``history``, ``profile``,
``doctor``, ``du``, ``worker``, ``serve``, ``sessions``, ``alerts``,
``fleet``, ``top``, ``loadgen`` and ``check`` subcommands, its
telemetry flags and ``--hash-linger-ms`` (reference surface:
bin/makisu/cmd/ — build flags build.go:97-135). Every command gets its
own metrics registry, event bus sinks, flight recorder and sampling
profiler, wired as the reference's ``main`` wires them, and writes the
reference's artifacts in the reference's schemas, so either package's
readers render the other's. ``--torch-profile DIR`` takes the place of
``--jax-profile``: a ``torch.profiler`` Chrome trace of the command, with
CPU and CUDA activity. ``--hasher gpu`` (the default, the counterpart of
``--hasher tpu``) chunks and fingerprints every committed layer on the
card and, with a cache, attaches chunk dedup (``<storage>/chunks/``;
with ``--push``, the first registry also carries the chunk packs);
``--hasher cpu`` records digests only and never touches the card. The
cache's KV store is Redis (``--redis-cache-addr``), else an HTTP
endpoint (``--http-cache-addr``), else ``<storage>/cache_key_value.json``.
Every
build leases a resident session for its context (``worker/session.py``;
``MAKISU_TPU_SESSION=0`` turns them off), so repeated builds in one
process replay untouched sources and cached layers; ``build --watch``
stays resident and rebuilds on every context change. ``worker`` serves
builds over a unix socket (``worker/server.py``): they run in its
process, on the card, and their ring passes share S1 launches through
the hash service; a worker also serves its storages' chunks, layer
recipes and packs to peers and delta pullers (``serve/``,
``fleet/peers.py``), as ``serve`` does for one storage dir;
``pull --delta SOCKET`` fetches only the chunks the local storage lacks;
``sessions`` and ``alerts`` read a worker. ``--storage-budget`` and
``--storage-remote`` (on ``build`` and ``worker``) bound a storage dir's
hot tier: after each build the content store (``storage/contentstore.py``)
demotes or evicts its coldest chunks and blobs; ``du`` and ``doctor
--storage`` read the storage census (``cache/census.py``); ``doctor
--device`` reads the device plane's probe ledger
(``utils/deviceprobe.py``, written by ``ops/backend.py``'s bounded
probe). ``fleet``
runs the build-farm front door over N workers (``fleet/``): it routes
each build by session affinity and consistent hash, fails over past a
dead or refusing worker, and runs canary builds (``--hasher gpu`` unless
``--canary-hasher cpu``); ``top``, ``doctor --fleet``, ``report
--fleet`` and ``profile --fleet`` read it, and ``loadgen`` drives a
worker or an in-process fleet. ``check`` lints this package's own tree
(``analysis/``) against its committed baseline. The flag of
makisu_tpu that this package has not ported (``--jax-profile``) is
rejected by the parser. A device error, a wedged card or a readback past
``MAKISU_TPU_SYNC_TIMEOUT`` fails the build: nothing retries on the CPU.
The readers, ``sessions``, ``alerts``, ``top``, ``check``, ``doctor
--device`` and the ``fleet`` front door never import torch.
"""

from __future__ import annotations

import argparse
import contextvars
import cProfile
import json
import os
import sys

import makisu_tpu_torch
from makisu_tpu_torch import tario
from makisu_tpu_torch.utils import concurrency, events, metrics, pathutils
from makisu_tpu_torch.utils import logging as log

# Commands that do build work: they run under the sampler, dump a bundle
# on failure and append history (build/pull/push).
_WORK_COMMANDS = ("build", "pull", "push", "diff")

# How this invocation was launched, for the build_info gauge and the
# session's residency hint: a worker sets "worker" around each build it
# runs (context-scoped, so a process hosting a worker and standalone
# builds labels each rightly).
invocation_mode: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "makisu_torch_invocation_mode", default="standalone")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="makisu-tpu-torch",
        description="Daemonless container image builder; layer chunk "
                    "fingerprints on an NVIDIA card.")
    parser.add_argument("--log-level", default="info",
                        choices=["debug", "info", "warn", "error"])
    parser.add_argument("--log-output", default="stdout",
                        help="stdout, stderr or a file path")
    parser.add_argument("--log-fmt", default="json",
                        choices=["json", "console"])
    parser.add_argument("--cpu-profile", action="store_true",
                        help="write a cProfile dump to "
                             "<tempdir>/makisu-tpu-torch.prof")
    parser.add_argument("--transfer-concurrency", type=int, default=0,
                        metavar="N",
                        help="parallel registry transfers (pulls, pushes, "
                             "chunk fetches) across the whole process "
                             "(default 8)")
    parser.add_argument("--transfer-memory-budget", type=int, default=0,
                        metavar="MB",
                        help="cap on transfer bytes resident in memory at "
                             "once, across all parallel transfers "
                             "(default 256)")
    parser.add_argument("--hash-workers", type=int, default=0,
                        metavar="N",
                        help="layer-commit pipeline workers (default "
                             "min(8, cpu) on >=4-core hosts, 1 below; "
                             "env MAKISU_TPU_HASH_WORKERS)")
    parser.add_argument("--compress-workers", type=int, default=0,
                        metavar="N",
                        help="block-parallel deflate lanes of the pgzip "
                             "backend; the bytes are the same at every "
                             "count (default min(8, cpu); env "
                             "MAKISU_TPU_COMPRESS_WORKERS)")
    parser.add_argument("--hash-linger-ms", type=float, default=-1.0,
                        metavar="MS",
                        help="shared hash-service batch linger in "
                             "milliseconds (a worker's cross-build S1 "
                             "batching; default 2; env "
                             "MAKISU_TPU_HASH_LINGER_MS)")
    parser.add_argument("--metrics-out", default="", metavar="FILE",
                        help="write a JSON telemetry report (span tree + "
                             "counters) for this command to FILE")
    parser.add_argument("--events-out", default="", metavar="FILE",
                        help="write this command's build events (JSONL, "
                             "one event per line) to FILE as they happen")
    parser.add_argument("--explain-out", default="", metavar="FILE",
                        help="write this command's cache-decision ledger "
                             "(JSONL, schema makisu-tpu.ledger.v1) to "
                             "FILE: the input of `explain`")
    parser.add_argument("--history-out", default="", metavar="FILE",
                        help="append one build-history record (JSONL, "
                             "schema makisu-tpu.history.v1) to FILE after "
                             "build/pull/push; without it, records land "
                             "in $MAKISU_TPU_HISTORY_DIR/history.jsonl "
                             "when set: the input of `history`")
    parser.add_argument("--diag-out", default="", metavar="FILE",
                        help="write a JSON diagnostic bundle (flight-"
                             "recorder ring, open spans, thread stacks, "
                             "resource trajectory) to FILE on failure, "
                             "stall, SIGTERM or SIGUSR1; without it, "
                             "bundles land in $MAKISU_TPU_DIAG_DIR when "
                             "set (stall and signal dumps fall back to "
                             "the tempdir)")
    parser.add_argument("--stall-timeout", type=float, default=0.0,
                        metavar="SECONDS",
                        help="arm a stall watchdog: when the build makes "
                             "no progress for this long, emit a `stall` "
                             "event and dump a diagnostic bundle "
                             "(default off; env MAKISU_TPU_STALL_TIMEOUT)")
    parser.add_argument("--trace-out", default="", metavar="FILE",
                        help="write a Chrome/Perfetto trace-event JSON of "
                             "this command's span tree to FILE")
    parser.add_argument("--torch-profile", default="", metavar="DIR",
                        help="capture a torch.profiler trace (CPU and "
                             "CUDA activity) of the command into DIR as "
                             "a Chrome trace")
    parser.add_argument("--profile-hz", type=float, default=None,
                        metavar="HZ",
                        help="wall-clock sampling profiler rate for this "
                             "command (default ~67 Hz, env "
                             "MAKISU_TPU_PROFILE_HZ; 0 disables); the "
                             "sampler throttles itself to stay under a "
                             "2%% overhead budget")
    parser.add_argument("--profile-out", default="", metavar="FILE",
                        help="write the sampled profile (schema "
                             "makisu-tpu.profile.v1) to FILE when the "
                             "command finishes: the input of `profile`")
    sub = parser.add_subparsers(dest="command")

    build = sub.add_parser("build", help="build a docker image")
    build.add_argument("context", help="build context directory")
    build.add_argument("-t", "--tag", required=True,
                       help="image tag (repo:tag)")
    build.add_argument("-f", "--file", default="",
                       help="Dockerfile path (default <context>/Dockerfile)")
    build.add_argument("--push", action="append", default=[],
                       metavar="REGISTRY",
                       help="push the built image to this registry")
    build.add_argument("--replica", action="append", default=[],
                       help="additional tags to save/push")
    build.add_argument("--registry-config", default="",
                       help="registry config file or inline JSON")
    build.add_argument("--dest", default="",
                       help="write a docker-save tar here")
    build.add_argument("--oci-dest", default="",
                       help="write an OCI image layout here (a directory,"
                            " or an oci-archive if the path ends in .tar)")
    build.add_argument("--target", default="",
                       help="build up to this stage only")
    build.add_argument("--build-arg", action="append", default=[],
                       metavar="K=V")
    build.add_argument("--modifyfs", action="store_true",
                       help="allow modifying the local filesystem")
    build.add_argument("--commit", default="implicit",
                       choices=["implicit", "explicit"],
                       help="layer commit policy (#!COMMIT honored in "
                            "explicit mode)")
    build.add_argument("--blacklist", action="append", default=[],
                       help="extra paths to exclude from layers")
    # Reference default: 14 days (bin/makisu/cmd/build.go:113-117).
    build.add_argument("--local-cache-ttl", default="336h")
    build.add_argument("--redis-cache-addr", default="")
    build.add_argument("--redis-cache-password", default="")
    build.add_argument("--http-cache-addr", default="")
    build.add_argument("--http-cache-header", action="append", default=[])
    build.add_argument("--docker-host",
                       default=os.environ.get("DOCKER_HOST",
                                              "unix:///var/run/docker.sock"))
    build.add_argument("--docker-version",
                       default=os.environ.get("DOCKER_VERSION", "1.21"))
    build.add_argument("--load", action="store_true",
                       help="load the image into the local docker daemon")
    build.add_argument("--storage", default="",
                       help="storage directory (default /makisu-storage or "
                            "$HOME fallback)")
    build.add_argument("--storage-budget", type=int, default=None,
                       metavar="MB",
                       help="hot-tier byte budget for the storage dir "
                            "(chunks + blobs); past it, cold objects "
                            "evict LRU after the build: chunks whose "
                            "pack has a compressed twin demote (bytes "
                            "recoverable locally), the rest refetch "
                            "via peers or the registry "
                            "(MAKISU_TPU_STORAGE_BUDGET_MB; "
                            "0/unset = unbounded)")
    build.add_argument("--storage-remote", default=None,
                       metavar="DIR",
                       help="remote/object tier directory: cold packs "
                            "demote there and refetch on demand "
                            "(MAKISU_TPU_STORAGE_REMOTE)")
    build.add_argument("--compression", default="default",
                       choices=sorted(tario.COMPRESSION_LEVELS))
    build.add_argument("--gzip-backend", default="zlib",
                       choices=["zlib", "pgzip", "auto"],
                       help="layer compressor: stdlib zlib, or the "
                            "block-parallel pgzip format on "
                            "--compress-workers lanes; auto resolves to "
                            "pgzip where the port's native codec "
                            "(csrc/pgzip.cpp) loads, else zlib, and the "
                            "resolved backend enters cache identity")
    build.add_argument("--preserve-root", action="store_true",
                       help="save and restore the root around the build")
    build.add_argument("--root", default="/",
                       help="build filesystem root (testing)")
    build.add_argument("--hasher", default="gpu", choices=["gpu", "cpu"],
                       help="layer hashing backend: gpu adds content-"
                            "defined chunk fingerprints computed on the "
                            "card; cpu records digests only")
    build.add_argument("--watch", action="store_true",
                       help="stay resident after the build and rebuild "
                            "whenever context files change (inotify "
                            "where available, else an mtime walk); the "
                            "resident session keeps the stat cache, the "
                            "scan memo and the applied layers warm, so "
                            "each rebuild scans and chunks only dirty "
                            "files. Ctrl-C exits with the last build's "
                            "code")
    build.add_argument("--watch-interval", type=float, default=1.0,
                       metavar="SECONDS",
                       help="change-poll interval of --watch (default "
                            "1.0)")

    pull = sub.add_parser("pull", help="pull an image into the store")
    pull.add_argument("image")
    pull.add_argument("--extract", default="",
                      help="untar the pulled rootfs into this directory")
    pull.add_argument("--oci-dest", default="",
                      help="also export the pulled image as an OCI "
                           "layout (directory, or .tar oci-archive)")
    pull.add_argument("--storage", default="")
    pull.add_argument("--registry-config", default="")
    pull.add_argument("--delta", default="", metavar="SOCKET",
                      help="delta pull: layer bytes come from this serve "
                           "endpoint (a `serve` or worker unix socket) as "
                           "coalesced ranged pack fetches of only the "
                           "chunks missing from the local chunk CAS; "
                           "manifest, config and identity still come from "
                           "the registry, and a layer without a published "
                           "recipe takes the registry blob route")
    pull.add_argument("--report-out", default="", metavar="FILE",
                      help="write the pull's economics report (bytes "
                           "fetched against the full image, per-layer "
                           "routes) as JSON")

    push = sub.add_parser("push", help="push an image tar to registries")
    push.add_argument("tar_path")
    push.add_argument("-t", "--tag", required=True)
    push.add_argument("--push", action="append", default=[],
                      metavar="REGISTRY", dest="registries")
    push.add_argument("--storage", default="")
    push.add_argument("--registry-config", default="")

    diff = sub.add_parser("diff", help="compare two images")
    diff.add_argument("images", nargs=2)
    diff.add_argument("--ignore-modtime", action="store_true")
    diff.add_argument("--storage", default="")
    diff.add_argument("--registry-config", default="")

    history = sub.add_parser(
        "history", help="render build-history trends, or `history "
                        "diff A B` to gate on regressions")
    history.add_argument("history_args", nargs="+",
                         metavar="PATH | diff A B",
                         help="history JSONL file(s) or directory "
                              "(rendered as a trend); or `diff A B` to "
                              "compare candidate B against baseline A "
                              "(exit 1 on a flagged regression)")
    history.add_argument("--threshold", type=float, default=0.25,
                         metavar="FRACTION",
                         help="diff regression threshold (default 0.25)")
    history.add_argument("--limit", type=int, default=20,
                         help="records shown in the trend view")

    report = sub.add_parser(
        "report", help="critical-path analysis of a telemetry report")
    report.add_argument("metrics_file",
                        help="a --metrics-out JSON report or a "
                             "diagnostic bundle (--diag-out); with "
                             "--fleet, the front door's merged "
                             "--events-out JSONL instead")
    report.add_argument("--events", default="", metavar="FILE",
                        help="an --events-out JSONL log to include "
                             "(torn final lines are salvaged)")
    report.add_argument("--fleet", action="store_true",
                        help="cross-process fleet analysis: assemble "
                             "one span tree per trace id from the "
                             "merged event log (front-door spans and "
                             "teed worker events) and render the "
                             "cross-process critical path; the "
                             "top-level --trace-out writes the merged "
                             "Perfetto export")
    report.add_argument("--profile", default="", metavar="FILE",
                        help="with --fleet: a makisu-tpu.profile.v1 "
                             "artifact (e.g. `profile --fleet --out`) "
                             "rendered beside the span analysis")

    explain = sub.add_parser(
        "explain", help="chunk-level cache miss attribution from a "
                        "build's decision ledger")
    explain.add_argument("ledger",
                         help="an --explain-out JSONL ledger (an "
                              "--events-out log also works)")
    explain.add_argument("--baseline", default="", metavar="LEDGER",
                         help="a previous build's ledger: render the "
                              "build-to-build diff")
    explain.add_argument("--metrics", default="", metavar="FILE",
                         help="the matching --metrics-out report: adds "
                              "the warm-rebuild floor profile")

    check = sub.add_parser(
        "check", help="repo-invariant static analysis: the six rules "
                      "distilled from shipped bugs (see "
                      "docs/ANALYSIS.md); exits 1 on any finding not "
                      "in the committed baseline")
    check.add_argument("paths", nargs="*", metavar="PATH",
                       help="files/directories to scan (default: the "
                            "makisu_tpu_torch package)")
    check.add_argument("--json", action="store_true", dest="json_out",
                       help="machine-readable output: one JSON object "
                            "with findings/suppressed/baseline (the CI "
                            "gate's artifact)")
    check.add_argument("--update-baseline", action="store_true",
                       help="rewrite the baseline to the current "
                            "finding set (review the diff!) and exit 0")
    check.add_argument("--baseline", default="", metavar="FILE",
                       help="baseline file (default: the committed "
                            "makisu_tpu_torch/analysis/baseline.json)")
    check.add_argument("--rule", action="append", default=[],
                       metavar="NAME",
                       help="run only this rule (repeatable)")

    doctor = sub.add_parser(
        "doctor", help="diagnose a failure-forensics bundle, a live "
                       "socket's alerts, a fleet (--fleet), the "
                       "storage planes (--storage), or the device "
                       "route (--device)")
    doctor.add_argument("bundle", nargs="?", default="",
                        help="a diagnostic bundle JSON (written by "
                             "--diag-out, the stall watchdog, or the "
                             "SIGTERM/SIGUSR1 handlers); a worker or "
                             "front-door socket (its active alerts); "
                             "with --fleet, the front door's socket; "
                             "with --storage, a worker socket or a "
                             "storage directory; with --device, the "
                             "deviceprobe ledger file or sessions "
                             "directory")
    doctor.add_argument("--device", action="store_true",
                        help="cross-session device-route diagnosis "
                             "from the makisu-tpu.deviceprobe.v1 "
                             "ledger: dominant wedge phase/frame, "
                             "per-attachment verdict history, last "
                             "healthy window (default ledger: "
                             "$MAKISU_TPU_DEVICE_SESSIONS_DIR or "
                             "build/device_sessions)")
    doctor.add_argument("--fleet", action="store_true",
                        help="cross-worker fleet diagnosis: poll the "
                             "front door's /healthz at the given "
                             "SOCKET and name dead/draining workers, "
                             "stale peer-map acks, tenants pinned at "
                             "their quota, and placement-memo drift "
                             "vs actual session residency")
    doctor.add_argument("--storage", action="store_true",
                        help="storage-plane diagnosis: census + "
                             "reference audit + integrity scrub of "
                             "the four content planes (blob CAS, "
                             "chunk CAS, packs, recipes). TARGET is "
                             "a worker control socket (remote "
                             "report) or a storage dir (local walk; "
                             "default: the standard storage dir). "
                             "Exit 1 when findings exist")
    doctor.add_argument("--repair", action="store_true",
                        help="with --storage on a DIRECTORY target: "
                             "delete verified-orphaned zpack twins "
                             "(without this flag the repair is a "
                             "dry-run listing)")
    doctor.add_argument("--eviction-budget", type=int, default=None,
                        metavar="BYTES",
                        help="with --storage: publish an eviction "
                             "dry-run: what eviction down to this byte "
                             "budget would remove and how many bytes "
                             "it would free (refused while the chunk "
                             "CAS LRU seed is incomplete)")

    du = sub.add_parser(
        "du", help="storage census: per-plane object counts, byte "
                   "totals, age histogram, per-tenant attribution")
    du.add_argument("--storage", default="",
                    help="storage directory (default: the standard "
                         "storage dir)")
    du.add_argument("--json", action="store_true", dest="json_out",
                    help="machine-readable census document "
                         "(makisu-tpu.census.v1)")

    profile = sub.add_parser(
        "profile", help="render and diff wall-clock sampling profiles "
                        "(makisu-tpu.profile.v1)")
    profile.add_argument("target", nargs="*", default=[],
                         help="a profile artifact to render; `diff "
                              "BASELINE CANDIDATE` to attribute a "
                              "regression to the frames whose self-time "
                              "share grew")
    profile.add_argument("--top", type=int, default=10,
                         help="functions to list per table (default 10)")
    profile.add_argument("--threshold", type=float, default=0.1,
                         metavar="FRACTION",
                         help="diff: flag frames whose self-time share "
                              "grew by more than this fraction of total "
                              "samples (default 0.1); exit 1 when any do")
    profile.add_argument("--flame", default="", metavar="FILE",
                         help="also write a self-contained flamegraph "
                              "HTML to FILE")
    profile.add_argument("--fleet", action="store_true",
                         help="TARGET is a fleet front door: ask every "
                              "alive worker for an on-demand --seconds "
                              "capture window and render the merged "
                              "profile")
    profile.add_argument("--seconds", type=float, default=5.0,
                         help="capture window for --fleet (default 5)")
    profile.add_argument("--out", default="", metavar="FILE",
                         help="also write the (merged) profile artifact "
                              "to FILE")

    worker = sub.add_parser("worker", help="run a long-lived build worker")
    worker.add_argument("--socket", default="/tmp/makisu-tpu-worker.sock",
                        help="unix socket to listen on")
    worker.add_argument("--max-concurrent-builds", type=int, default=0,
                        metavar="N",
                        help="cap concurrently executing builds; "
                             "arrivals beyond the cap wait in a FIFO "
                             "admission queue (makisu_worker_queue_depth, "
                             "queue-wait/latency histograms, GET /builds). "
                             "0 = unlimited (default; env "
                             "MAKISU_TPU_MAX_CONCURRENT_BUILDS)")
    worker.add_argument("--slo-config", default="", metavar="FILE",
                        help="SLO rule JSON merged over the built-in "
                             "worker rules by name; evaluated on a "
                             "background thread, firing alerts at GET "
                             "/alerts")
    worker.add_argument("--alert-webhook", default="", metavar="URL",
                        help="POST each alert fired/resolved transition "
                             "here as JSON (bounded timeout; failures "
                             "counted, never blocking)")
    worker.add_argument("--storage-budget", type=int, default=None,
                        metavar="MB",
                        help="hot-tier byte budget per storage dir "
                             "this worker builds against; enforced "
                             "after each build and on the scrub "
                             "cadence (MAKISU_TPU_STORAGE_BUDGET_MB; "
                             "0/unset = unbounded)")
    worker.add_argument("--storage-remote", default=None,
                        metavar="DIR",
                        help="remote/object tier directory for cold "
                             "pack demotion (MAKISU_TPU_STORAGE_REMOTE)")

    serve = sub.add_parser(
        "serve", help="run a chunk-native distribution endpoint over a "
                      "storage directory (signed layer recipes and "
                      "ranged pack serving for delta pulls)")
    serve.add_argument("--socket", default="/tmp/makisu-tpu-serve.sock",
                       help="unix socket to listen on")
    serve.add_argument("--storage", default="",
                       help="storage directory to serve (a builder's "
                            "--storage; recipes and packs under serve/, "
                            "chunk bytes under chunks/)")

    fleet = sub.add_parser(
        "fleet", help="run the build-farm front door: route builds "
                      "across N workers by session affinity")
    fleet.add_argument("--socket", default="/tmp/makisu-tpu-fleet.sock",
                       help="unix socket the front door listens on (it "
                            "speaks the worker protocol: clients, top "
                            "and loadgen point here unchanged)")
    fleet.add_argument("--worker", action="append", default=[],
                       metavar="SOCKET[=STORAGE]",
                       help="one fleet member's worker socket (repeat "
                            "per worker); an optional =STORAGE "
                            "overrides --storage on builds forwarded to "
                            "it (same-host fleets modelling "
                            "per-machine disks)")
    fleet.add_argument("--poll-interval", type=float, default=1.0,
                       metavar="SECONDS",
                       help="worker /healthz + /sessions poll cadence "
                            "(the affinity and liveness signal)")
    fleet.add_argument("--tenant-quota", type=int, default=0, metavar="N",
                       help="per-tenant in-flight build quota at the "
                            "front door; excess builds wait (FIFO) and "
                            "the wait is recorded as a quota_denied "
                            "decision (0 = unlimited)")
    fleet.add_argument("--max-inflight-builds", type=int, default=0,
                       metavar="N",
                       help="fleet-wide in-flight cap across all "
                            "tenants (0 = unlimited)")
    fleet.add_argument("--spillover-queue-depth", type=int, default=2,
                       metavar="N",
                       help="load score (queue depth + in-flight) at "
                            "which the consistent-hash owner of a new "
                            "context is passed over for the "
                            "least-loaded worker")
    fleet.add_argument("--slo-config", default="", metavar="FILE",
                       help="SLO rule JSON merged over the built-in "
                            "fleet rules by name; evaluated over "
                            "scheduler stats and canary series, served "
                            "at GET /alerts")
    fleet.add_argument("--alert-webhook", default="", metavar="URL",
                       help="POST each alert fired/resolved transition "
                            "here as JSON")
    fleet.add_argument("--canary-interval", type=float, default=60.0,
                       metavar="SECONDS",
                       help="synthetic canary build cadence: each sweep "
                            "builds one tiny generated context on every "
                            "alive worker, scoring per-worker health "
                            "for health-demoted routing (0 disables)")
    fleet.add_argument("--canary-slow-seconds", type=float, default=10.0,
                       metavar="SECONDS",
                       help="canary latency past this counts as bad")
    fleet.add_argument("--canary-hasher", default="gpu",
                       choices=["cpu", "gpu"],
                       help="hasher of the canary builds (default gpu: "
                            "a canary reaches each worker's card)")

    top = sub.add_parser(
        "top", help="live terminal view of a worker's (or fleet front "
                    "door's) builds")
    top.add_argument("--socket", default="/tmp/makisu-tpu-worker.sock",
                     help="worker or front-door unix socket to poll")
    top.add_argument("--interval", type=float, default=2.0,
                     metavar="SECONDS", help="refresh interval")
    top.add_argument("--once", action="store_true",
                     help="print a single frame and exit (no screen "
                          "clearing; for scripts)")
    top.add_argument("--count", type=int, default=0, metavar="N",
                     help="exit after N frames (0 = until interrupted)")

    loadgen = sub.add_parser(
        "loadgen", help="synthetic concurrent-build load harness "
                        "against a real worker or fleet")
    loadgen.add_argument("--socket", default="",
                         help="drive this live worker (default: spawn an "
                              "in-process worker for the run)")
    loadgen.add_argument("--concurrency", type=int, default=4,
                         metavar="N", help="concurrent submission lanes")
    loadgen.add_argument("--builds", type=int, default=0, metavar="M",
                         help="total builds to run (default "
                              "2 x concurrency)")
    loadgen.add_argument("--contexts", type=int, default=0, metavar="K",
                         help="distinct generated context templates "
                              "(default = concurrency, capped at it)")
    loadgen.add_argument("--files", type=int, default=16,
                         help="files per generated context")
    loadgen.add_argument("--file-kb", type=int, default=4,
                         help="KiB per generated file")
    loadgen.add_argument("--edit-churn", type=float, default=0.25,
                         metavar="FRACTION",
                         help="fraction of a lane's files append-edited "
                              "before each rebuild")
    loadgen.add_argument("--tenants", default="tenant-a,tenant-b",
                         help="comma-separated tenant mix, assigned to "
                              "lanes round-robin")
    loadgen.add_argument("--hasher", default="gpu", choices=["cpu", "gpu"],
                         help="hashing backend of the synthetic builds "
                              "(gpu, the default, chunks on the card "
                              "through the shared hash service)")
    loadgen.add_argument("--max-concurrent-builds", type=int, default=0,
                         metavar="N",
                         help="admission cap of the SPAWNED worker(s) "
                              "(ignored with --socket)")
    loadgen.add_argument("--report", default="", metavar="FILE",
                         help="write the structured JSON report (schema "
                              "makisu-tpu.loadgen.v1) here")
    loadgen.add_argument("--work-dir", default="",
                         help="working directory for contexts and "
                              "storage (default: a tempdir, removed "
                              "after)")
    loadgen.add_argument("--poll-interval", type=float, default=0.5,
                         metavar="SECONDS",
                         help="/healthz + /builds sampling interval")
    loadgen.add_argument("--ready-timeout", type=float, default=30.0,
                         metavar="SECONDS",
                         help="how long to wait for the worker's /ready")
    loadgen.add_argument("--fleet", action="store_true",
                         help="fleet mode: a single-worker baseline, "
                              "then --workers in-process workers behind "
                              "the front door with a shared cache KV; "
                              "drain and kill between rounds; reports "
                              "distribution, affinity hit rate, the "
                              "p99 delta, peer chunk exchange, failover "
                              "and digest identity")
    loadgen.add_argument("--workers", type=int, default=3, metavar="N",
                         help="fleet mode: in-process workers behind the "
                              "front door")
    loadgen.add_argument("--tenant-quota", type=int, default=1,
                         metavar="N",
                         help="fleet mode: per-tenant in-flight quota at "
                              "the front door (0 disables the quota "
                              "phase)")
    loadgen.add_argument("--rounds", type=int, default=0, metavar="R",
                         help="fleet mode: builds per context (default "
                              "3; >= 3 so warmup, drain and kill each "
                              "get a round)")
    loadgen.add_argument("--slo-smoke", action="store_true",
                         help="SLO fault-injection scenario: a 3-worker "
                              "fleet with fast canary and evaluation "
                              "intervals, one worker wedged by held "
                              "admission slots; the burn alert must "
                              "fire, routing shift away, canary digests "
                              "agree, and the alert resolve")
    loadgen.add_argument("--alert-events-out", default="", metavar="FILE",
                         help="slo-smoke: write the alert transitions as "
                              "an alert-only NDJSON file")
    loadgen.add_argument("--evict-soak", action="store_true",
                         help="eviction soak scenario: an edited-rebuild "
                              "stream against a tiny-budget storage and "
                              "an unbudgeted oracle; evictions fire, "
                              "disk reaches steady state, digests match "
                              "the oracle, the scrub finds nothing")
    loadgen.add_argument("--prewarm-smoke", action="store_true",
                         help="session-snapshot recovery scenario: a "
                              "worker killed after a resident build, a "
                              "fresh worker over the same storage "
                              "rebuilds restored and byte-identical; "
                              "then a 2-worker fleet drains a session "
                              "holder and the next build lands on the "
                              "prewarmed survivor")

    alerts_p = sub.add_parser(
        "alerts", help="render a worker's or fleet front door's active "
                       "alerts (GET /alerts)")
    alerts_p.add_argument("socket",
                          help="worker or fleet unix socket to query")
    alerts_p.add_argument("--json", action="store_true", dest="json_out",
                          help="print the raw /alerts JSON payload "
                               "instead of the human render")

    sessions_p = sub.add_parser(
        "sessions", help="inspect a worker's resident build sessions, "
                         "or checkpoint/restore them through the "
                         "chunk-addressed snapshot plane")
    sessions_p.add_argument("socket", help="worker unix socket to query")
    sessions_p.add_argument("verb", nargs="?", default="list",
                            choices=("list", "snapshot", "restore"),
                            help="list sessions (default), snapshot "
                                 "resident sessions to the chunk CAS, "
                                 "or restore/stage a snapshot")
    sessions_p.add_argument("context", nargs="?", default="",
                            help="context dir (optional for snapshot: "
                                 "all sessions; required for restore)")
    sessions_p.add_argument("--from", dest="from_socket", default="",
                            help="restore: pull the recipe from this "
                                 "worker's socket and push it to SOCKET")
    sessions_p.add_argument("--json", action="store_true", dest="json_out",
                            help="print raw JSON payloads")

    sub.add_parser("version", help="print the build version")
    return parser


def _storage_dir(flag: str) -> str:
    if flag:
        return flag
    if os.path.isdir(os.path.dirname(pathutils.DEFAULT_STORAGE_DIR) or "/") \
            and os.access("/", os.W_OK):
        return pathutils.DEFAULT_STORAGE_DIR
    return os.path.join(os.path.expanduser("~"), ".makisu-tpu-storage")


def _parse_build_args(pairs: list[str]) -> dict[str, str]:
    out = {}
    for pair in pairs:
        key, sep, val = pair.partition("=")
        if not sep:
            val = os.environ.get(key, "")
        out[key] = val
    return out


def _new_cache_manager(args, store, registry_client=None):
    """The KV store: Redis, then HTTP, then the storage's file store."""
    from makisu_tpu_torch.cache import (
        CacheManager,
        FSStore,
        HTTPStore,
        RedisStore,
    )
    from makisu_tpu_torch.dockerfile import parse_duration
    ttl = parse_duration(args.local_cache_ttl) / 1e9
    if args.redis_cache_addr:
        kv = RedisStore(args.redis_cache_addr, ttl,
                        args.redis_cache_password)
    elif args.http_cache_addr:
        headers = dict(h.split(":", 1) for h in args.http_cache_header)
        kv = HTTPStore(args.http_cache_addr, headers)
    elif args.local_cache_ttl in ("0", "0s"):
        return None
    else:
        kv = FSStore(os.path.join(store.root, pathutils.CACHE_KV_FILE_NAME),
                     ttl)
    return CacheManager(kv, store, registry_client=registry_client)


def _config_map(args):
    """Per-command registry config map (never the process-global one)."""
    from makisu_tpu_torch.registry import load_config_map
    return (load_config_map(args.registry_config)
            if args.registry_config else None)


def cmd_build(args, device=None) -> int:
    from makisu_tpu_torch.storage import contentstore
    storage_dir = _storage_dir(args.storage)
    if args.storage_budget is not None:
        # Per dir, not process-wide: a worker runs many builds against
        # many dirs, and one build's flag must not rebudget the others.
        contentstore.set_budget_for(storage_dir,
                                    max(0, args.storage_budget) << 20)
    if args.storage_remote is not None:
        contentstore.configure(remote=args.storage_remote)
    if args.watch:
        if invocation_mode.get() != "worker":
            return _watch_loop(args, device)
        # A worker build runs on a handler thread; an endless watch loop
        # would pin it (and its session lease) forever. The worker is
        # already the resident process.
        log.warning("--watch is ignored in worker mode (the worker "
                    "itself is the resident process)")
    code = _build_once(args, device)
    # The byte budget holds from the moment the disk grew (throttled; a
    # no-op unbudgeted; never fails a finished build).
    contentstore.store_for(storage_dir).maybe_evict()
    return code


def _watch_loop(args, device=None) -> int:
    """``build --watch``: build, then stay resident and rebuild on every
    context change. Changes come from the build session's dirty tracker
    (inotify where available); without a session (MAKISU_TPU_SESSION=0)
    a standalone mtime-walk snapshot polls. A failed rebuild keeps
    watching; Ctrl-C returns the last build's code, after the stat
    cache's last save has landed."""
    import time as time_mod

    from makisu_tpu_torch.worker import session as session_mod
    walk_mod = session_mod.walk_mod

    interval = max(0.1, args.watch_interval)
    context_dir = os.path.abspath(args.context)
    # The standalone poll must ignore the build's own output dirs: a
    # storage or root inside the context would re-trigger forever.
    poll_blacklist = [os.path.abspath(_storage_dir(args.storage)),
                      os.path.abspath(args.root)]

    def safe_build() -> int:
        """One rebuild that never unwinds the loop: a broken Dockerfile
        or a half-renamed COPY source is the normal rhythm of editing."""
        try:
            return _build_once(args, device)
        except KeyboardInterrupt:
            raise
        except SystemExit as e:
            log.error("watch: build exited: %s", e.code)
            return e.code if isinstance(e.code, int) else 1
        except Exception as e:  # noqa: BLE001 - watch must survive
            log.error("watch: build failed: %s", e)
            return 1

    code = safe_build()
    builds = 1
    snapshot = None
    log.info("watch: initial build exited %d; watching %s "
             "(interval %.1fs, Ctrl-C to exit)", code, context_dir,
             interval)
    try:
        while True:
            session = session_mod.manager().peek(context_dir)
            if session is not None:
                dirt = session.poll_changes()
            else:
                try:
                    if snapshot is None:
                        snapshot = walk_mod.snapshot_tree(
                            context_dir, poll_blacklist)
                        dirt = set()
                    else:
                        snapshot, delta = walk_mod.snapshot_delta(
                            snapshot, poll_blacklist)
                        dirt = delta.real_dirty
                except OSError:
                    # The context churned mid-walk: take a new baseline
                    # next tick.
                    snapshot = None
                    dirt = set()
            if dirt:
                sample = sorted(dirt)[:3]
                log.info("watch: %d paths changed (%s); rebuilding",
                         len(dirt), ", ".join(
                             os.path.relpath(p, context_dir)
                             for p in sample))
                code = safe_build()
                builds += 1
                log.info("watch: rebuild #%d exited %d", builds, code)
                snapshot = None  # a new baseline for the standalone poll
            else:
                time_mod.sleep(interval)
    except KeyboardInterrupt:
        # A terminal's Ctrl-C reaches the whole process group: a second
        # interrupt may land mid-log; exit quietly either way.
        try:
            session = session_mod.manager().peek(context_dir)
            if session is not None and session.content_ids is not None:
                session.content_ids.flush()
            log.info("watch: stopped after %d builds", builds)
        except KeyboardInterrupt:
            pass
        return code


def _build_once(args, device=None) -> int:
    from makisu_tpu_torch.builder import BuildPlan
    from makisu_tpu_torch.cache import NoopCacheManager
    from makisu_tpu_torch.chunker import get_hasher
    from makisu_tpu_torch.context import BuildContext
    from makisu_tpu_torch.docker.image import ImageName
    from makisu_tpu_torch.dockerfile import parse_file
    from makisu_tpu_torch.registry import new_client
    from makisu_tpu_torch.storage import ImageStore

    registry_config_map = _config_map(args)
    # Only concrete backends enter cache identity: `auto` resolves here.
    gzip_backend = tario.resolve_backend(args.gzip_backend)
    if args.gzip_backend == "auto":
        log.info("gzip backend auto-selected: %s", gzip_backend)
    gzip_backend_id = tario.make_backend_id(gzip_backend, args.compression)
    blacklist = list(pathutils.DEFAULT_BLACKLIST)
    for extra in args.blacklist:
        if extra not in blacklist:
            blacklist.append(extra)

    dockerfile_path = args.file or os.path.join(args.context, "Dockerfile")
    with open(dockerfile_path) as f:
        stages = parse_file(f.read(), _parse_build_args(args.build_arg))

    target = ImageName.parse(args.tag)
    replicas = [ImageName.parse(r) for r in args.replica]
    # The card is resolved here, before any work: a host without CUDA
    # fails the gpu hasher at once (unless the caller asked for the CPU).
    hasher = get_hasher(args.hasher, device=device)

    with ImageStore(_storage_dir(args.storage)) as store:
        ctx = BuildContext(args.root, os.path.abspath(args.context), store,
                           hasher=hasher, blacklist=blacklist,
                           gzip_backend_id=gzip_backend_id)
        # The first push registry doubles as the cache's blob and chunk
        # plane (as the reference's registryCacheManager,
        # lib/cache/cache_manager.go:116-182): a KV hit from another
        # builder materializes from there, lazily, and at chunk
        # granularity when the gpu hasher indexed the layer.
        cache_registry = None
        if args.push:
            cache_registry = new_client(
                store, target.with_registry(args.push[0]),
                config_map=registry_config_map)
        cache_mgr = (_new_cache_manager(args, store, cache_registry)
                     or NoopCacheManager())
        if args.hasher == "gpu" and not isinstance(cache_mgr,
                                                   NoopCacheManager):
            from makisu_tpu_torch.cache import attach_chunk_dedup
            attach_chunk_dedup(cache_mgr, os.path.join(store.root, "chunks"))
        preserver = None
        if args.preserve_root and args.modifyfs:
            from makisu_tpu_torch.storage.root_preserver import RootPreserver
            preserver = RootPreserver(args.root, store.sandbox_dir,
                                      ctx.blacklist)
        # Resident build session: lease (or mint) the warm state of this
        # context and resolved-flag identity, immediately before the try
        # whose finally releases it. Every outcome lands on the decision
        # ledger (source=session) and the history record's warm_mode.
        from makisu_tpu_torch.utils import ledger as ledger_mod
        from makisu_tpu_torch.worker import session as session_mod
        build_session = None
        if session_mod.enabled():
            build_session, verdict = session_mod.manager().acquire(
                ctx.context_dir, session_mod.identity_from_build_args(
                    args, store.root, gzip_backend_id),
                restore_spec=(
                    store.root,
                    session_mod.portable_identity_from_build_args(
                        args, gzip_backend_id)))
        else:
            verdict = "disabled"
        build_ok = False
        try:
            if build_session is not None:
                mode = build_session.begin_build(
                    ctx, resident_process=(
                        invocation_mode.get() == "worker" or args.watch))
                session_mod.set_warm_mode(
                    mode if verdict in ("hit", "restored") else "fresh")
                ledger_mod.record(
                    "session", ctx.context_dir, verdict,
                    reason=("reused" if verdict == "hit"
                            else "restored" if verdict == "restored"
                            else "created"),
                    mode=mode, dirty=len(ctx.dirty_paths),
                    resident_bytes=build_session.resident_bytes())
            else:
                session_mod.set_warm_mode("off")
                log.info("build session off (%s)", verdict)
                ledger_mod.record("session", ctx.context_dir, "miss",
                                  reason=verdict)
            plan = BuildPlan(ctx, target, replicas, cache_mgr, stages,
                             allow_modify_fs=args.modifyfs,
                             force_commit=(args.commit == "implicit"),
                             stage_target=args.target,
                             registry_client=_FromPuller(
                                 store, registry_config_map))
            plan.execute()
            build_ok = True
        finally:
            if preserver is not None:
                preserver.restore()
            if build_session is not None:
                # A failed build makes the dirty set inexact (the next
                # build scans everything); a successful one re-arms the
                # tracker so the next rebuild is O(dirty).
                build_session.finish_build(ctx, build_ok)
                session_mod.manager().release(build_session)
        log.info("successfully built image %s", target)

        # Lazily served cache hits hold no local blob: a push
        # materializes a blob only when the target registry cannot
        # HEAD-skip it (materialize_blob), an export needs every byte.
        materializer = getattr(cache_mgr, "materialize", None)
        push_jobs = [(image, registry) for registry in args.push
                     for image in (target, *replicas)]

        def push_one(job):
            image, registry = job
            name = image.with_registry(registry)
            client = new_client(store, name, config_map=registry_config_map)
            client.materialize_blob = materializer
            client.push(name if name.registry else image)
            log.info("successfully pushed %s to %s", name, registry)

        if len(push_jobs) == 1:
            push_one(push_jobs[0])
        elif push_jobs:
            # Image-level fan-out on a small pool of its own; the blob
            # transfers inside share the transfer engine (whose tasks
            # must stay leaves).
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(min(4, len(push_jobs))) as pool:
                concurrency.ctx_map(pool, push_one, push_jobs)
        if args.dest or args.oci_dest or args.load:
            cache_mgr.materialize_pending()
        if args.dest:
            from makisu_tpu_torch.docker.save import write_save_tar
            write_save_tar(store, target, args.dest)
            log.info("saved image tar to %s", args.dest)
        if args.oci_dest:
            from makisu_tpu_torch.docker.oci import write_oci_layout
            digest = write_oci_layout(store, target, args.oci_dest)
            log.info("saved OCI layout to %s (manifest %s)", args.oci_dest,
                     digest)
        if args.load:
            from makisu_tpu_torch.docker.daemon import DockerClient
            from makisu_tpu_torch.docker.save import write_save_tar
            tar_path = os.path.join(store.sandbox_dir, "load.tar")
            write_save_tar(store, target, tar_path)
            DockerClient(args.docker_host,
                         args.docker_version).image_tar_load(tar_path)
            log.info("loaded image into docker daemon")
    log.info("finished building %s", target)
    return 0


class _FromPuller:
    """Registry access of FROM steps: a client per image name; the
    manifest is saved under the image's own name."""

    def __init__(self, store, config_map=None) -> None:
        self.store = store
        self.config_map = config_map

    def _client(self, name):
        from makisu_tpu_torch.registry import new_client
        return new_client(self.store, name, config_map=self.config_map)

    def pull(self, name):
        return self._client(name).pull(name)

    def start_pull(self, name):
        """Pipelined: layer downloads run ahead on the transfer engine
        while the layers apply in order."""
        return self._client(name).start_pull(name)


def cmd_pull(args) -> int:
    from makisu_tpu_torch.docker.image import ImageName
    from makisu_tpu_torch.registry import new_client
    from makisu_tpu_torch.storage import ImageStore

    name = ImageName.parse_for_pull(args.image)
    with ImageStore(_storage_dir(args.storage)) as store:
        client = new_client(store, name, config_map=_config_map(args))
        if args.delta:
            from makisu_tpu_torch.serve import pull_image_delta
            manifest, report = pull_image_delta(client, store, name,
                                                args.delta)
        else:
            # Which layers were local before the pull (pull_layer skips
            # them): the report says so, as the delta report does. It
            # costs a manifest GET, so only when a report is asked for.
            local: set[str] = set()
            if args.report_out:
                pre = client.pull_manifest(name.tag)
                local = {d.digest.hex() for d in pre.layers
                         if store.layers.exists(d.digest.hex())}
            manifest = client.pull(name)
            if args.report_out:
                # The delta report's builder, so both files read alike;
                # repeated digests count once, as in the delta walk.
                from makisu_tpu_torch.serve.client import build_pull_report
                uniq: dict[str, int] = {}
                for d in manifest.layers:
                    uniq.setdefault(d.digest.hex(), d.size)
                report = build_pull_report(name, "", [
                    {"layer": hx,
                     "route": "local" if hx in local else "blob",
                     "size": size,
                     "bytes_fetched": 0 if hx in local else size}
                    for hx, size in uniq.items()])
        if args.report_out:
            from makisu_tpu_torch.utils import fileio
            fileio.write_json_atomic(args.report_out, report)
        log.info("pulled %s (%d layers)", name, len(manifest.layers))
        if args.oci_dest:
            from makisu_tpu_torch.docker.oci import write_oci_layout
            digest = write_oci_layout(store, name, args.oci_dest)
            log.info("saved OCI layout to %s (manifest %s)", args.oci_dest,
                     digest)
        if args.extract:
            from makisu_tpu_torch.snapshot import MemFS
            os.makedirs(args.extract, exist_ok=True)
            fs = MemFS(args.extract, blacklist=[])
            for desc in manifest.layers:
                fs.update_from_tar_path(store.layers.path(desc.digest.hex()),
                                        untar=True)
            log.info("extracted rootfs to %s", args.extract)
    return 0


def cmd_push(args) -> int:
    from makisu_tpu_torch.docker.image import ImageName
    from makisu_tpu_torch.docker.save import load_save_tar
    from makisu_tpu_torch.registry import new_client
    from makisu_tpu_torch.storage import ImageStore

    config_map = _config_map(args)
    name = ImageName.parse(args.tag)
    with ImageStore(_storage_dir(args.storage)) as store:
        load_save_tar(store, args.tar_path, name)
        registries = args.registries or [name.registry]
        if not all(registries):
            raise SystemExit("no registry to push to (use --push)")

        def push_to(registry):
            target = name.with_registry(registry)
            store.manifests.save(target, store.manifests.load(name))
            new_client(store, target, config_map=config_map).push(target)
            log.info("pushed %s", target)

        if len(registries) == 1:
            push_to(registries[0])
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(min(4, len(registries))) as pool:
                concurrency.ctx_map(pool, push_to, registries)
    return 0


def cmd_diff(args) -> int:
    import tempfile

    from makisu_tpu_torch.docker.image import ImageName
    from makisu_tpu_torch.registry import new_client
    from makisu_tpu_torch.snapshot import MemFS
    from makisu_tpu_torch.storage import ImageStore

    config_map = _config_map(args)
    with ImageStore(_storage_dir(args.storage)) as store:
        trees = []
        configs = []
        for image in args.images:
            name = ImageName.parse_for_pull(image)
            manifest = new_client(store, name,
                                  config_map=config_map).pull(name)
            with store.layers.open(manifest.config.digest.hex()) as f:
                configs.append(json.load(f))
            root = tempfile.mkdtemp(dir=store.sandbox_dir)
            fs = MemFS(root, blacklist=[])
            for desc in manifest.layers:
                fs.update_from_tar_path(
                    store.layers.path(desc.digest.hex()), untar=False)
            trees.append(fs)
        # Whole-config deep diff (reference: cmd/diff.go:117-120).
        for line in _deep_diff(*configs):
            print(line)
        diff = trees[0].compare(trees[1], ignore_mtime=args.ignore_modtime)
        for p in diff.missing_in_first:
            print(f"only in {args.images[1]}: {p}")
        for p in diff.missing_in_second:
            print(f"only in {args.images[0]}: {p}")
        for p, h1, h2 in diff.different:
            print(f"differs: {p} "
                  f"[{h1.mode:o} {h1.uid}:{h1.gid} {h1.size}] vs "
                  f"[{h2.mode:o} {h2.uid}:{h2.gid} {h2.size}]")
    return 0


def _deep_diff(a, b, path: str = "") -> list[str]:
    """Recursive structural diff of two JSON-ish values, one line per
    differing leaf (the reference's go-cmp report)."""
    if isinstance(a, dict) and isinstance(b, dict):
        lines = []
        for key in sorted(set(a) | set(b)):
            sub = f"{path}.{key}" if path else key
            if key not in a:
                lines.append(f"{sub}: <absent> != {b[key]!r}")
            elif key not in b:
                lines.append(f"{sub}: {a[key]!r} != <absent>")
            else:
                lines.extend(_deep_diff(a[key], b[key], sub))
        return lines
    if a != b:
        return [f"{path or '<root>'}: {a!r} != {b!r}"]
    return []


def cmd_report(args) -> int:
    """Critical-path analysis of a build's telemetry: a ``--metrics-out``
    report (with its ``--events-out`` log), or a diagnostic bundle of a
    build that died mid-flight, whose metrics snapshot is analyzed
    instead. ``--fleet`` reads the front door's merged event log and
    renders one cross-process span tree per trace id."""
    from makisu_tpu_torch.utils import flightrecorder, traceexport

    if args.fleet:
        try:
            event_log = events.read_jsonl(args.metrics_file)
        except ValueError as e:
            log.warning("%s; analyzing the valid lines only", e)
            event_log = events.read_jsonl(args.metrics_file,
                                          skip_invalid=True)
        assembled = traceexport.assemble_fleet_trace(event_log)
        if not assembled["traces"]:
            raise SystemExit(
                f"{args.metrics_file}: no span events to assemble "
                f"(expected a fleet --events-out log with "
                f"span_start/span_end lines)")
        fleet_profile = None
        if args.profile:
            from makisu_tpu_torch.utils import profiler as profiler_mod
            try:
                fleet_profile = profiler_mod.read_artifact(args.profile)
            except ValueError as e:
                log.error("%s", e)
                raise SystemExit(2)
        print(traceexport.render_fleet_report(assembled,
                                              profile=fleet_profile),
              end="")
        if args.trace_out:
            metrics.write_json_atomic(
                args.trace_out, traceexport.fleet_perfetto_trace(assembled))
            log.info("merged fleet trace written to %s", args.trace_out)
            # The generic trace write would clobber the merged export
            # with this invocation's (empty) span tree.
            args.trace_out = ""
        return 0
    with open(args.metrics_file, encoding="utf-8") as f:
        report = json.load(f)
    capture_ts = None
    if report.get("schema") == flightrecorder.BUNDLE_SCHEMA:
        bundle, report = report, report.get("metrics")
        capture_ts = bundle.get("ts")
        if report is None:
            raise SystemExit(
                f"{args.metrics_file}: bundle carries no metrics "
                f"snapshot (the dying process held the registry lock); "
                f"try `doctor` for the thread and span forensics")
    if report.get("schema") != "makisu-tpu.metrics.v1":
        raise SystemExit(
            f"{args.metrics_file}: not a makisu-tpu metrics report "
            f"(schema {report.get('schema')!r})")
    event_log = None
    if args.events:
        try:
            event_log = events.read_jsonl(args.events)
        except ValueError as e:
            # A build killed mid-write leaves a torn last line: analyze
            # the valid prefix.
            log.warning("%s; analyzing the valid lines only", e)
            event_log = events.read_jsonl(args.events, skip_invalid=True)
    print(traceexport.render_report(report, event_log,
                                    capture_ts=capture_ts), end="")
    return 0


def cmd_explain(args) -> int:
    """Render a cache-decision ledger: which node broke the cache chain
    and which files broke it, what flipped between two builds
    (``--baseline``), where the warm-rebuild floor goes (``--metrics``).
    Torn ledgers are salvaged line by line."""
    from makisu_tpu_torch.utils import explain as explain_mod
    from makisu_tpu_torch.utils import ledger as ledger_mod

    def load(path: str) -> dict:
        try:
            led = ledger_mod.read_ledger(path)
        except ValueError as e:
            log.warning("%s; analyzing the valid lines only", e)
            led = ledger_mod.read_ledger(path, skip_invalid=True)
        if not led["decisions"] and not led["header"]:
            raise SystemExit(
                f"{path}: no ledger header or cache_decision lines "
                f"(expected an --explain-out file, schema "
                f"{ledger_mod.LEDGER_SCHEMA!r})")
        return led

    current = load(args.ledger)
    if args.baseline:
        print(explain_mod.render_diff(current, load(args.baseline)), end="")
        return 0
    report = None
    if args.metrics:
        with open(args.metrics, encoding="utf-8") as f:
            report = json.load(f)
        if report.get("schema") != "makisu-tpu.metrics.v1":
            raise SystemExit(
                f"{args.metrics}: not a makisu-tpu metrics report "
                f"(schema {report.get('schema')!r})")
    print(explain_mod.render_explain(current, report), end="")
    return 0


def cmd_check(args) -> int:
    """Run the static-analysis rule engine over the tree: six rules
    distilled from shipped bugs (ctx propagation, signal safety,
    metric-name registry, atomic durable writes, silent swallows,
    unbounded I/O). Pre-existing findings live in the committed
    baseline; anything new exits 1 naming the rule, file, and line."""
    from makisu_tpu_torch import analysis

    rules = analysis.default_rules()
    if args.rule:
        wanted = set(args.rule)
        known = {r.name for r in rules}
        unknown = wanted - known
        if unknown:
            raise SystemExit(
                f"unknown rule(s) {', '.join(sorted(unknown))}; "
                f"valid: {', '.join(sorted(known))}")
        rules = [r for r in rules if r.name in wanted]
    paths = args.paths or analysis.default_scan_paths()
    root = analysis.repo_root()
    baseline_path = args.baseline or analysis.default_baseline_path()
    if args.update_baseline and not args.baseline \
            and (args.rule or args.paths):
        # write_baseline REPLACES the file with the current finding
        # set; updating the committed baseline from a filtered scan
        # would silently discard every other rule's/path's entries. An
        # explicit --baseline names a file the caller owns, so partial
        # scopes are fine there.
        raise SystemExit(
            "--update-baseline with --rule/PATH filters would drop "
            "every unscanned finding from the committed baseline; "
            "run it unfiltered, or pass an explicit --baseline FILE")
    findings = analysis.run_check(paths, rules, root=root)
    if args.update_baseline:
        analysis.write_baseline(baseline_path, findings)
        log.info("baseline updated: %d finding(s) recorded in %s",
                 len(findings), baseline_path)
        return 0
    baseline = analysis.load_baseline(baseline_path)
    new, suppressed = analysis.apply_baseline(findings, baseline)
    if args.json_out:
        print(json.dumps({
            "schema": "makisu-tpu.check.v1",
            "findings": [f.to_dict() for f in new],
            "suppressed": suppressed,
            "baseline": os.path.relpath(baseline_path, root)
            if baseline_path.startswith(root) else baseline_path,
            "rules": sorted(r.name for r in rules),
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        print(f"makisu-tpu check: {len(new)} new finding(s), "
              f"{suppressed} baseline-suppressed")
    return 1 if new else 0


def cmd_du(args) -> int:
    """Walk the four content planes (blob CAS, chunk CAS, packs,
    recipes) under the census IO budget and print per-plane object
    counts, byte totals, the age histogram, and per-tenant attribution.
    ``--json`` prints the makisu-tpu.census.v1 document (also cached at
    ``<storage>/census.json`` for history records)."""
    from makisu_tpu_torch.cache import census as census_mod

    storage_dir = _storage_dir(args.storage)
    if not os.path.isdir(storage_dir):
        raise SystemExit(f"{storage_dir}: not a directory")
    doc = census_mod.StorageCensus(storage_dir).census()
    if args.json_out:
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(census_mod.render_du(doc), end="")
    return 0


def _doctor_storage(args) -> int:
    """``doctor --storage TARGET``: census + reference audit +
    integrity scrub. A socket target asks the worker for its report
    (the worker's own IO budget and scrub cadence apply); a directory
    target walks locally and can ``--repair`` orphaned zpack twins.
    Exit 1 when any finding survives."""
    import stat as stat_mod

    from makisu_tpu_torch.cache import census as census_mod

    target = args.bundle
    is_socket = False
    if target:
        try:
            is_socket = stat_mod.S_ISSOCK(os.stat(target).st_mode)
        except OSError:
            is_socket = False
    if is_socket:
        if args.repair:
            raise SystemExit(
                "doctor --storage --repair needs a storage DIRECTORY "
                "target (repair deletes files; run it where the files "
                "are, not through a worker socket)")
        from makisu_tpu_torch.worker.client import WorkerClient
        try:
            report = WorkerClient(target).storage(
                eviction_budget=args.eviction_budget)
        except (OSError, RuntimeError, ValueError) as e:
            raise SystemExit(f"worker on {target} not reachable: {e}")
        entries = list(report.get("storage") or [])
    else:
        storage_dir = _storage_dir(target)
        if not os.path.isdir(storage_dir):
            raise SystemExit(
                f"{storage_dir}: neither a worker socket nor a storage "
                f"directory")
        census = census_mod.StorageCensus(storage_dir)
        entry = {"storage_dir": storage_dir,
                 "census": census.census(),
                 "audit": census.audit(),
                 "scrub": census.scrub()}
        from makisu_tpu_torch.storage import contentstore
        entry["contentstore"] = \
            contentstore.store_for(storage_dir).describe()
        seed = census_mod.seed_states(storage_dir)
        if seed:
            entry["lru_seed"] = seed
        if args.eviction_budget is not None:
            entry["eviction_dry_run"] = census.eviction_dry_run(
                args.eviction_budget, seed_state=seed)
        repairable = [f for f in entry["audit"]["findings"]
                      if f.get("repairable")]
        if repairable:
            entry["repair"] = census.repair_orphaned_zpacks(
                repairable, apply=args.repair)
        entries = [entry]
    print(census_mod.render_storage_doctor(
        entries, target or "local storage"), end="")
    total = sum(
        len((e.get("audit") or {}).get("findings") or [])
        + len((e.get("scrub") or {}).get("findings") or [])
        for e in entries)
    return 1 if total else 0


def cmd_doctor(args) -> int:
    """Render a diagnostic bundle into a diagnosis: the stuck span,
    wedged threads, the transfer backlog and the resource trajectory up
    to the capture. ``--storage`` diagnoses the storage planes,
    ``--fleet SOCKET`` a fleet through its front door's ``/healthz``,
    ``--device [LEDGER|DIR]`` the device route from the deviceprobe
    ledger, and a socket in place of a bundle renders that process's
    alerts."""
    import stat as stat_mod

    from makisu_tpu_torch.utils import flightrecorder

    if args.storage:
        return _doctor_storage(args)
    if args.fleet:
        from makisu_tpu_torch.fleet import doctor as fleet_doctor
        from makisu_tpu_torch.worker.client import WorkerClient
        if not args.bundle:
            raise SystemExit(
                "doctor --fleet needs the front door's socket path: "
                "`doctor --fleet SOCKET`")
        client = WorkerClient(args.bundle)
        try:
            health = client.healthz()
        except (OSError, RuntimeError, ValueError) as e:
            raise SystemExit(
                f"fleet front door on {args.bundle} not reachable: {e}")
        if "fleet" not in health:
            raise SystemExit(
                f"{args.bundle} answers /healthz but carries no fleet "
                f"section — is it a worker socket? point doctor --fleet "
                f"at the `fleet` socket")
        # Active alerts render as findings; a front door without
        # /alerts still gets the healthz-digest fallback.
        alerts_snap = None
        try:
            alerts_snap = client.alerts()
        except (OSError, RuntimeError, ValueError):
            pass
        print(fleet_doctor.render_fleet_doctor(health, args.bundle,
                                               alerts=alerts_snap),
              end="")
        return 0
    if args.device:
        from makisu_tpu_torch.utils import deviceprobe
        records = deviceprobe.read_records(args.bundle or None)
        if not records:
            where = (args.bundle or deviceprobe.sessions_dir()
                     or "$MAKISU_TPU_DEVICE_SESSIONS_DIR (unset)")
            raise SystemExit(
                f"no {deviceprobe.SCHEMA} records found in {where}; "
                f"probe attempts record there when a device is "
                f"configured (or when MAKISU_TPU_DEVICE_SESSIONS_DIR "
                f"is set explicitly)")
        print(deviceprobe.render_device_doctor(records), end="")
        return 0
    if not args.bundle:
        raise SystemExit(
            "doctor needs a diagnostic-bundle path (or --device for "
            "the device-route ledger diagnosis)")
    if os.path.exists(args.bundle) and stat_mod.S_ISSOCK(
            os.stat(args.bundle).st_mode):
        # A live control socket in place of a bundle: its active alerts
        # as a diagnosis (a worker or a front door; the payload names
        # itself).
        from makisu_tpu_torch.fleet import doctor as fleet_doctor
        from makisu_tpu_torch.utils import alerts as alerts_mod
        from makisu_tpu_torch.worker.client import WorkerClient
        try:
            snap = WorkerClient(args.bundle).alerts()
        except (OSError, RuntimeError, ValueError) as e:
            raise SystemExit(
                f"{args.bundle} is a socket but /alerts failed: {e}")
        print(alerts_mod.render_alerts(
            snap, heading=f"{snap.get('source') or '?'} alerts — "
                          f"{args.bundle}"))
        findings = fleet_doctor.alert_findings(snap)
        if findings:
            print(f"\ndiagnosis ({len(findings)} finding(s)):")
            for f in findings:
                print(f"  [{f['severity']:<7s}] {f['detail']}")
        return 0
    with open(args.bundle, encoding="utf-8") as f:
        bundle = json.load(f)
    if bundle.get("schema") != flightrecorder.BUNDLE_SCHEMA:
        raise SystemExit(
            f"{args.bundle}: not a makisu-tpu diagnostic bundle "
            f"(schema {bundle.get('schema')!r}); bundles are written "
            f"by --diag-out, the stall watchdog, or SIGTERM/SIGUSR1")
    print(flightrecorder.render_doctor(bundle), end="")
    return 0


def cmd_history(args) -> int:
    """``history PATH...`` renders the trend; ``history diff A B``
    compares candidate B against baseline A. Exit codes: 0 ok, 1 a
    regression beyond ``--threshold``, 2 unreadable input."""
    from makisu_tpu_torch.utils import history as history_mod
    tokens = args.history_args

    def read(path: str) -> list[dict]:
        try:
            return history_mod.read_history(path)
        except OSError as e:
            log.error("cannot read history %s: %s", path, e)
            raise SystemExit(2)

    if tokens[0] == "diff":
        if len(tokens) != 3:
            raise SystemExit(
                "history diff takes exactly two history paths: "
                "`history diff BASELINE CANDIDATE`")
        result = history_mod.diff(read(tokens[1]), read(tokens[2]),
                                  threshold=args.threshold)
        print(history_mod.render_diff(result), end="")
        return 0 if result["ok"] else 1
    records: list[dict] = []
    for path in tokens:
        records.extend(read(path))
    records.sort(key=lambda r: r.get("ts", 0.0))
    print(history_mod.render_trends(records, limit=args.limit), end="")
    return 0


def cmd_profile(args) -> int:
    """``profile ARTIFACT`` renders the phase-attributed breakdown
    (``--flame`` adds a flamegraph HTML); ``profile diff BASELINE
    CANDIDATE`` names the frames whose self-time share grew; ``profile
    --fleet SOCKET`` captures and merges a window from every alive
    worker behind a front door. Exit codes as ``history diff``'s."""
    from makisu_tpu_torch.utils import profiler as profiler_mod
    tokens = args.target

    def read(path: str) -> dict:
        try:
            return profiler_mod.read_artifact(path)
        except ValueError as e:
            log.error("%s", e)
            raise SystemExit(2)

    if args.fleet:
        from makisu_tpu_torch.worker.client import WorkerClient
        if not tokens:
            raise SystemExit(
                "profile --fleet needs the front door's socket path: "
                "`profile --fleet SOCKET`")
        client = WorkerClient(tokens[0],
                              control_timeout=args.seconds + 30.0)
        try:
            doc = client.profile(seconds=args.seconds)
        except (OSError, RuntimeError, ValueError) as e:
            raise SystemExit(
                f"fleet profile capture from {tokens[0]} failed: {e}")
    elif tokens and tokens[0] == "diff":
        if len(tokens) != 3:
            raise SystemExit(
                "profile diff takes exactly two artifacts: "
                "`profile diff BASELINE CANDIDATE`")
        result = profiler_mod.diff(read(tokens[1]), read(tokens[2]),
                                   threshold=args.threshold)
        print(profiler_mod.render_diff(result), end="")
        return 0 if result["ok"] else 1
    elif len(tokens) == 1:
        doc = read(tokens[0])
    else:
        raise SystemExit("profile takes one artifact path, `diff "
                         "BASELINE CANDIDATE`, or `--fleet SOCKET`")
    print(profiler_mod.render_profile(doc, top=args.top), end="")
    if args.flame:
        try:
            with open(args.flame, "w", encoding="utf-8") as f:
                f.write(profiler_mod.flamegraph_html(doc))
            log.info("flamegraph written to %s", args.flame)
        except OSError as e:
            log.error("failed to write flamegraph: %s", e)
            return 1
    if args.out:
        try:
            profiler_mod.write_artifact(args.out, doc)
            log.info("profile artifact written to %s", args.out)
        except OSError as e:
            log.error("failed to write profile artifact: %s", e)
            return 1
    return 0


def cmd_worker(args, device=None) -> int:
    """Serve builds over ``--socket`` until ``GET /exit`` or SIGINT; the
    builds run on ``device`` (None: the card)."""
    from makisu_tpu_torch.utils import flightrecorder
    from makisu_tpu_torch.worker import WorkerServer
    if args.storage_budget is not None or args.storage_remote is not None:
        # Worker-wide defaults: every storage dir this worker builds
        # against inherits them (a build's own --storage-budget still
        # overrides per dir).
        from makisu_tpu_torch.storage import contentstore
        contentstore.configure(budget_mb=args.storage_budget,
                               remote=args.storage_remote)
    server = WorkerServer(args.socket,
                          stall_window=args.stall_timeout or None,
                          diag_out=args.diag_out,
                          max_concurrent_builds=args.max_concurrent_builds,
                          slo_config=args.slo_config,
                          alert_webhook=args.alert_webhook, device=device)
    # Process-level signal forensics: a SIGTERM'd or SIGUSR1'd worker
    # dumps a bundle covering every in-flight build (the server's
    # recorder sees every context's events, and the process registry's
    # trace id keeps every build's open spans).
    flightrecorder.install_signal_dumps(
        server.recorder, metrics.global_registry(), args.diag_out)
    log.info("worker listening on %s", args.socket)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def cmd_serve(args) -> int:
    """The standalone distribution endpoint: read-only recipes and
    ranged pack serving over one storage directory that a builder or a
    worker fills; workers embed the same handlers on their sockets."""
    from makisu_tpu_torch.serve import ServeServer
    server = ServeServer(args.socket, _storage_dir(args.storage))
    stats = server.store.stats()
    log.info("serve endpoint on %s over %s (%d recipe(s), %d pack(s), "
             "%d pack bytes)", args.socket, server.storage_dir,
             stats["recipes"], stats["packs"], stats["pack_bytes"])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def cmd_fleet(args) -> int:
    """Run the build-farm front door over ``--worker`` sockets: session
    affinity, consistent-hash placement with least-loaded spillover,
    tenant quotas, failover, and the peer map the workers fetch chunks
    by. It routes and forwards only; the builds run in the workers."""
    from makisu_tpu_torch.fleet import FleetServer, WorkerSpec
    from makisu_tpu_torch.utils import flightrecorder
    if not args.worker:
        raise SystemExit("fleet needs at least one --worker "
                         "SOCKET[=STORAGE]")
    specs = [WorkerSpec.parse(flag, i)
             for i, flag in enumerate(args.worker)]
    # Routing happens on handler and poll threads with no bound
    # context: the --events-out/--explain-out sinks bound for this
    # command serve the whole process while the server runs.
    promoted = events.promote_context_sinks()
    server = FleetServer(
        args.socket, specs,
        poll_interval=args.poll_interval,
        tenant_quota=args.tenant_quota,
        max_inflight=args.max_inflight_builds,
        spillover_queue_depth=args.spillover_queue_depth,
        stall_window=(args.stall_timeout or None),
        diag_out=args.diag_out,
        slo_config=args.slo_config,
        alert_webhook=args.alert_webhook,
        canary_interval=args.canary_interval,
        canary_slow_seconds=args.canary_slow_seconds,
        canary_hasher=args.canary_hasher)
    # SIGTERM dumps a bundle of every in-flight routed build; SIGUSR1
    # dumps one live and keeps serving.
    flightrecorder.install_signal_dumps(
        server.recorder, metrics.global_registry(), args.diag_out)
    log.info("fleet front door listening on %s (%d workers: %s)",
             args.socket, len(specs),
             ", ".join(s.socket_path for s in specs))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # The workers' serve-access rows (bytes on the wire of peer and
        # delta fetches) live only in the workers: pull them in before
        # the sinks demote, for --events-out and the merged trace.
        try:
            for access_event in server.collect_serve_access():
                events.deliver(access_event)
        except Exception as e:  # noqa: BLE001 - shutdown must proceed
            log.warning("serve-access collection failed: %s", e)
        trace_events = server.trace_events()
        server.server_close()
        events.demote_sinks(promoted)
        if args.trace_out:
            # The merged cross-process trace, written here (and the
            # flag cleared): the generic write sees only this
            # invocation's empty registry.
            from makisu_tpu_torch.utils import traceexport
            try:
                assembled = traceexport.assemble_fleet_trace(trace_events)
                metrics.write_json_atomic(
                    args.trace_out,
                    traceexport.fleet_perfetto_trace(assembled))
                log.info("merged fleet trace written to %s "
                         "(%d trace(s), %d span(s))", args.trace_out,
                         len(assembled.get("traces", [])),
                         assembled.get("span_count", 0))
            except (OSError, ValueError) as e:
                log.error("failed to write merged fleet trace: %s", e)
            args.trace_out = ""
    return 0


def cmd_top(args) -> int:
    """Live terminal view of a worker or a front door, polled from
    ``/builds`` and ``/healthz``."""
    from makisu_tpu_torch.tools import top
    return top.run(args)


def cmd_loadgen(args, device=None) -> int:
    """The synthetic load harness (``tools/loadgen.py``); the workers it
    spawns build on ``device`` (None: the card)."""
    from makisu_tpu_torch.tools import loadgen
    return loadgen.run(args, device=device)


def cmd_alerts(args) -> int:
    """Render ``GET /alerts`` of a worker or a front door: active alerts
    severity first, the recently resolved ring, and on a front door each
    worker's own section and the canary state."""
    from makisu_tpu_torch.utils import alerts as alerts_mod
    from makisu_tpu_torch.worker.client import WorkerClient
    try:
        snap = WorkerClient(args.socket).alerts()
    except (OSError, RuntimeError, ValueError) as e:
        raise SystemExit(f"cannot fetch /alerts from {args.socket}: {e}")
    if args.json_out:
        print(json.dumps(snap, indent=1))
        return 0
    source = snap.get("source") or "?"
    print(alerts_mod.render_alerts(
        snap, heading=f"{source} alerts — {args.socket}"))
    for wid, payload in sorted((snap.get("workers") or {}).items()):
        print()
        if payload.get("error"):
            print(f"worker {wid}: {payload['error']}")
        else:
            print(alerts_mod.render_alerts(
                payload, heading=f"worker {wid}"))
    canary = snap.get("canary") or {}
    if canary.get("workers"):
        print(f"\ncanary: {canary.get('sweeps', 0)} sweep(s), digest "
              f"mismatch={str(bool(canary.get('digest_mismatch'))).lower()}")
        for wid, row in sorted(canary["workers"].items()):
            print(f"  {wid}: score {row.get('score', 1.0):g} "
                  f"({row.get('bad', 0)}/{row.get('total', 0)} bad, "
                  f"last {row.get('latency_seconds', 0):g}s"
                  + (f", error: {row['error']}" if row.get("error")
                     else "") + ")")
    return 0


def cmd_sessions(args) -> int:
    """A worker's resident sessions: ``sessions SOCKET`` lists them and
    the snapshot counters; ``snapshot [CONTEXT]`` checkpoints them into
    the snapshot plane; ``restore CONTEXT [--from SRC]`` stages a
    snapshot onto SOCKET (the recipe pulled from SRC when given)."""
    from makisu_tpu_torch.worker.client import WorkerClient
    client = WorkerClient(args.socket)
    try:
        if args.verb == "snapshot":
            payload = client.snapshot_sessions(args.context)
            if args.json_out:
                print(json.dumps(payload, indent=1))
            else:
                print(f"checkpointed {payload.get('snapshotted', 0)} "
                      f"session(s)")
            return 0
        if args.verb == "restore":
            if not args.context:
                raise SystemExit("sessions restore requires a context dir")
            if args.from_socket:
                recipe = WorkerClient(
                    args.from_socket).session_snapshot(args.context)
                payload = client.restore_session({"recipe": recipe})
            else:
                payload = client.restore_session({"context": args.context})
            if args.json_out:
                print(json.dumps(payload, indent=1))
            elif payload.get("ok"):
                print("snapshot staged; the next build on this context "
                      "restores warm")
            else:
                print("restore refused: "
                      f"{payload.get('reason') or 'unknown'}")
            return 0 if payload.get("ok") else 1
        snap = client.sessions()
    except (OSError, RuntimeError, ValueError) as e:
        raise SystemExit(
            f"sessions {args.verb} via {args.socket} failed: {e}")
    if args.json_out:
        print(json.dumps(snap, indent=1))
        return 0
    sessions = snap.get("sessions") or []
    print(f"{len(sessions)} resident session(s) — {args.socket}")
    for row in sessions:
        print(f"  {row.get('context', '?')}: builds={row.get('builds', 0)} "
              f"bytes={row.get('resident_bytes', 0)} "
              f"exact={str(bool(row.get('exact'))).lower()} "
              f"busy={str(bool(row.get('busy'))).lower()}")
    counters = snap.get("snapshot") or {}
    if counters:
        print("snapshot: " + " ".join(
            f"{k}={counters[k]}" for k in
            ("write", "write_error", "restore", "restore_refused",
             "restore_error") if k in counters))
        failure = counters.get("last_restore_failure") or {}
        if failure.get("reason"):
            print(f"  last restore failure: {failure.get('context', '?')} "
                  f"({failure['reason']})")
    return 0


def _platform_label(device) -> str:
    """The device the command runs on: ``cuda`` unless the caller asked
    for another one (the tests' ``device="cpu"``). No torch import."""
    return "cuda" if device is None else str(device).split(":")[0]


def _kernel_route_label(args, device) -> str:
    """``ops.backend.kernel_route()``, resolved first for a gpu build
    (which resolves its device first thing anyway), else whatever the
    process already resolved; ``unresolved`` without one. Reading the
    route never loads a library, and a command that never touched the
    device plane never imports torch for the label."""
    if args.command == "build" and getattr(args, "hasher", "") == "gpu":
        try:
            from makisu_tpu_torch.ops import backend
            backend.resolve_device(device)
        except Exception:  # noqa: BLE001 - the build itself reports it
            pass
    mod = sys.modules.get("makisu_tpu_torch.ops.backend")
    route = mod.kernel_route() if mod is not None else None
    return route or "unresolved"


def _start_torch_profile(args, device):
    """``--torch-profile DIR``: a torch.profiler session over the
    command, with CUDA activity where the command runs on the card, on
    every thread of the process (a build's cache pushes run on threads
    of their own). The port's spans enter the trace as
    ``user_annotation`` events (``ops/backend.py``'s span mirror)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig

    from makisu_tpu_torch.ops import backend  # noqa: F401 - the mirror
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _platform_label(device) == "cuda" and torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    return prof


def _stop_torch_profile(prof, out_dir: str, tag: str) -> None:
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"torch-profile-{os.getpid()}-{tag}.json")
    prof.export_chrome_trace(path)
    log.info("torch profiler trace written to %s", path)


def main(argv: list[str] | None = None, device=None) -> int:
    """Run one command; returns its exit code (1 on any failure).

    ``device`` is where the gpu hasher's kernels run: None is the card;
    tests pass ``device="cpu"`` to run the kernels' plain versions.
    """
    parser = make_parser()
    args = parser.parse_args(argv)
    log.configure(args.log_level.replace("warn", "warning"), args.log_fmt,
                  args.log_output)
    if args.transfer_concurrency or args.transfer_memory_budget:
        from makisu_tpu_torch.registry import transfer
        transfer.configure(args.transfer_concurrency,
                           args.transfer_memory_budget)
    if args.hash_linger_ms >= 0:
        # Process-wide: the hash service batches across builds.
        concurrency.set_hash_linger_ms(args.hash_linger_ms)
    if args.command == "version":
        print(makisu_tpu_torch.BUILD_HASH)
        return 0
    handlers = {"build": lambda a: cmd_build(a, device), "pull": cmd_pull,
                "push": cmd_push, "diff": cmd_diff, "report": cmd_report,
                "explain": cmd_explain, "doctor": cmd_doctor, "du": cmd_du,
                "history": cmd_history, "profile": cmd_profile,
                "worker": lambda a: cmd_worker(a, device),
                "serve": cmd_serve, "alerts": cmd_alerts,
                "sessions": cmd_sessions, "fleet": cmd_fleet,
                "top": cmd_top, "check": cmd_check,
                "loadgen": lambda a: cmd_loadgen(a, device)}
    handler = handlers.get(args.command)
    if handler is None:
        parser.print_help()
        return 1
    # A fresh context per command: what the command binds (worker
    # counts, the metrics registry, event sinks, the chunk observer)
    # ends with it.
    return contextvars.copy_context().run(_run_command, args, handler,
                                          device)


def _run_command(args, handler, device) -> int:
    """One command under its telemetry, in the order of the reference's
    ``main``: registry, build info, flight recorder and resource
    sampler, signal dumps, profiler, sinks, watchdog, build_start/end,
    the failure dump, the ``build telemetry`` line, history and the
    report writes. Telemetry never fails the command: every write is
    guarded."""
    if args.hash_workers > 0:
        concurrency.set_hash_workers(args.hash_workers)
    if args.compress_workers > 0:
        concurrency.set_compress_workers(args.compress_workers)
    cprofile = None
    if args.cpu_profile:
        cprofile = cProfile.Profile()
        cprofile.enable()
    torch_prof = None
    if args.torch_profile:
        torch_prof = _start_torch_profile(args, device)
    # Every invocation gets its own registry, bound to this context; the
    # process-global registry still aggregates.
    registry = metrics.MetricsRegistry()
    metrics.adopt_inbound(registry, metrics.inbound_traceparent())
    metrics.set_build_registry(registry)
    alerts_fired_base = metrics.global_registry().counter_total(
        metrics.ALERTS_FIRED)
    metrics.gauge_set(
        metrics.BUILD_INFO, 1,
        version=makisu_tpu_torch.__version__,
        command=args.command or "",
        hasher=getattr(args, "hasher", "") or "",
        platform=_platform_label(device),
        mode=invocation_mode.get(),
        hash_workers=concurrency.hash_workers(),
        compress_workers=concurrency.compress_workers(),
        native_isa=_kernel_route_label(args, device))
    # Failure forensics: a flight recorder (a ring of recent events and
    # log records) and the process resource sampler; on failure, stall,
    # SIGTERM or SIGUSR1 the recorder dumps a bundle `doctor` reads.
    from makisu_tpu_torch.utils import flightrecorder, resources
    resources.ensure_started()
    events.bind_progress_cell()
    recorder = flightrecorder.FlightRecorder()
    recorder_tokens = flightrecorder.install(recorder)
    old_signal_handlers = flightrecorder.install_signal_dumps(
        recorder, registry, args.diag_out, tag=registry.trace_id[:8])
    # Continuous profiling of the commands that do work: this thread is
    # bound to the trace id; a process-level sampler already running is
    # reused, not doubled.
    from makisu_tpu_torch.utils import profiler as profiler_mod
    sampler = None
    sampler_thread_token = None
    if args.command in _WORK_COMMANDS + ("loadgen",):
        sampler_thread_token = profiler_mod.bind_thread(registry.trace_id)
        if profiler_mod.process_profiler() is None:
            sample_hz = profiler_mod.resolve_hz(args.profile_hz)
            if sample_hz > 0:
                sampler = profiler_mod.SamplingProfiler(
                    hz=sample_hz).start()
                profiler_mod.set_process_profiler(sampler)
    events_writer = None
    events_token = None
    if args.events_out:
        try:
            events_writer = events.JsonlWriter(args.events_out)
            events_token = events.add_sink(events_writer)
        except OSError as e:
            log.error("failed to open events log %s: %s",
                      args.events_out, e)
    # The cache-decision ledger is a sink on the same bus.
    ledger_writer = None
    ledger_token = None
    if args.explain_out:
        from makisu_tpu_torch.utils import ledger as ledger_mod
        try:
            ledger_writer = ledger_mod.LedgerWriter(
                args.explain_out, trace_id=registry.trace_id,
                command=args.command or "")
            ledger_token = events.add_sink(ledger_writer)
        except OSError as e:
            log.error("failed to open cache ledger %s: %s",
                      args.explain_out, e)
    # The watchdog starts after every sink is bound: its `stall` event
    # reaches the recorder and the --events-out log. The long-lived
    # `worker`, `fleet` and `serve` are idle between requests by design,
    # so they run none (their servers arm their own, gated on builds).
    watchdog = None
    stall_timeout = (args.stall_timeout
                     or flightrecorder.stall_timeout_from_env())
    if stall_timeout > 0 and args.command not in ("worker", "fleet",
                                                  "serve"):
        watchdog = flightrecorder.StallWatchdog(
            stall_timeout, recorder,
            flightrecorder.forced_bundle_path(
                args.diag_out, "stall", tag=registry.trace_id[:8]),
            registry, cell=events.progress_cell()).start()
    # argv stays out of the event: it can carry credentials.
    events.emit("build_start", trace_id=registry.trace_id,
                command=args.command or "",
                version=makisu_tpu_torch.__version__)
    code = 1
    try:
        with metrics.span(args.command or "cli"):
            code = handler(args)
        return code
    except SystemExit as e:
        # A signal handler's SystemExit(143) or a subcommand's
        # SystemExit(msg): build_end and the failure dump see the code.
        code = (e.code if isinstance(e.code, int)
                else 0 if e.code is None else 1)
        raise
    except Exception as e:  # noqa: BLE001 - top-level CLI boundary
        log.error("failed to execute command: %s", e)
        if args.log_level == "debug":
            raise
        return 1
    finally:
        events.emit("build_end", trace_id=registry.trace_id,
                    exit_code=code)
        if watchdog is not None:
            watchdog.stop()
        flightrecorder.restore_signal_handlers(old_signal_handlers)
        if (code != 0 and args.command in _WORK_COMMANDS
                and not recorder.captured_terminal_moment()):
            # A stall or SIGTERM dump already froze the moment that
            # matters; otherwise a failure dumps here (opt-in through
            # --diag-out or $MAKISU_TPU_DIAG_DIR).
            diag_path = flightrecorder.resolve_bundle_path(
                args.diag_out, "failure", tag=registry.trace_id[:8])
            if diag_path:
                try:
                    recorder.dump(diag_path, "failure", registry,
                                  exit_code=code)
                    log.info("diagnostic bundle written to %s", diag_path)
                except OSError as e:
                    log.error("failed to write diagnostic bundle: %s", e)
        elif recorder.last_dump_path:
            log.info("diagnostic bundle written to %s",
                     recorder.last_dump_path)
        if events_token is not None:
            events.reset_sink(events_token)
        if events_writer is not None:
            events_writer.close()
            log.info("event log written to %s", args.events_out)
        if ledger_token is not None:
            events.reset_sink(ledger_token)
        if ledger_writer is not None:
            # Closed after build_end: the summary line carries its code.
            ledger_writer.close()
            log.info("cache ledger written to %s", args.explain_out)
        flightrecorder.uninstall(recorder_tokens)
        if torch_prof is not None:
            try:
                _stop_torch_profile(torch_prof, args.torch_profile,
                                    registry.trace_id[:8])
            except Exception as e:  # noqa: BLE001 - telemetry
                log.error("failed to write torch profiler trace: %s", e)
        if cprofile is not None:
            import tempfile
            cprofile.disable()
            path = os.path.join(tempfile.gettempdir(),
                                "makisu-tpu-torch.prof")
            cprofile.dump_stats(path)
            log.info("cpu profile written to %s", path)
        if sampler_thread_token is not None:
            profiler_mod.unbind_thread(sampler_thread_token)
        if sampler is not None:
            # Stopped before the snapshot: the artifact's duration is
            # the command's, not the teardown's.
            sampler.stop()
        active_sampler = sampler or profiler_mod.process_profiler()
        if args.profile_out:
            if active_sampler is not None:
                try:
                    profiler_mod.write_artifact(
                        args.profile_out, active_sampler.snapshot(
                            command=args.command or ""))
                    log.info("profile written to %s", args.profile_out)
                except OSError as e:
                    log.error("failed to write profile: %s", e)
            else:
                log.info("profile requested but the sampler is disabled "
                         "(--profile-hz 0 / MAKISU_TPU_PROFILE_HZ=0)")
        if sampler is not None:
            profiler_mod.set_process_profiler(None)
        if args.command == "build":
            # One greppable line of the build's vital signs, with the
            # port's own four: seconds per span name over the build's
            # tree, the card's kernel seconds (CUDA events), the entries
            # written into the build's layer tars, and the chunk
            # store's existence answers by route.
            log.info("build telemetry", exit_code=code,
                     **metrics.summary(registry),
                     span_seconds=metrics.span_seconds(registry),
                     device_busy_seconds=round(registry.counter_total(
                         metrics.DEVICE_BUSY_SECONDS), 6),
                     commit_entries=int(registry.counter_total(
                         metrics.COMMIT_ENTRIES)),
                     chunk_probes={route: int(n) for route, n in sorted(
                         registry.counter_by_label(
                             metrics.CHUNK_PROBES, "route").items())})
        _write_reports(args, registry, code, alerts_fired_base)


def _write_reports(args, registry, code: int,
                   alerts_fired_base: float) -> None:
    """The history append and the --metrics-out / --trace-out writes,
    all from one ``registry.report()``."""
    history_path = ""
    if args.command in ("build", "pull", "push"):
        from makisu_tpu_torch.utils import history as history_mod
        history_path = history_mod.resolve_out(args.history_out)
    if not (args.metrics_out or args.trace_out or history_path):
        return
    report = registry.report()
    report["command"] = args.command or ""
    report["exit_code"] = code
    if history_path:
        # The storage planes beside the perf gates, from the cached
        # census totals only (``<storage>/census.json``, written by the
        # last walk): a history append never pays for a store walk.
        from makisu_tpu_torch.cache import census as census_mod
        try:
            storage_bytes = census_mod.cached_totals(
                _storage_dir(getattr(args, "storage", "")))
        except (TypeError, ValueError):  # a malformed census.json
            storage_bytes = None
        extra = {"storage_bytes": storage_bytes} if storage_bytes else {}
        try:
            history_mod.append_record(
                history_path, history_mod.record_from_report(
                    report, command=args.command or "", exit_code=code,
                    alerts_fired=int(
                        metrics.global_registry().counter_total(
                            metrics.ALERTS_FIRED) - alerts_fired_base),
                    **extra))
            log.info("history record appended to %s", history_path)
        except OSError as e:
            log.error("failed to append history record: %s", e)
    if args.metrics_out:
        try:
            metrics.write_json_atomic(args.metrics_out, report)
            log.info("telemetry report written to %s", args.metrics_out)
        except OSError as e:
            log.error("failed to write telemetry report: %s", e)
    if args.trace_out:
        try:
            from makisu_tpu_torch.utils import traceexport
            metrics.write_json_atomic(args.trace_out,
                                      traceexport.perfetto_trace(report))
            log.info("perfetto trace written to %s", args.trace_out)
        except OSError as e:
            log.error("failed to write perfetto trace: %s", e)


if __name__ == "__main__":
    sys.exit(main())
