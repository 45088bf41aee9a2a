"""makisu-tpu-torch command line: build / pull / push / diff / version.

    python -m makisu_tpu_torch.cli build CTX -t repo:tag [--hasher gpu|cpu]
        [--push REGISTRY] [--gzip-backend zlib|pgzip|auto]
    python -m makisu_tpu_torch.cli pull REGISTRY/repo:tag
    python -m makisu_tpu_torch.cli push IMAGE.tar -t repo:tag --push REGISTRY
    python -m makisu_tpu_torch.cli diff IMAGE_A IMAGE_B

Copy of ``makisu_tpu/cli.py``'s ``build``, ``pull``, ``push``, ``diff``
and ``version`` subcommands (reference surface: bin/makisu/cmd/ — build
flags build.go:97-135). ``--hasher gpu`` (the default, the counterpart of
``--hasher tpu``) chunks and fingerprints every committed layer on the
card and, with a cache, attaches chunk dedup (``<storage>/chunks/``;
with ``--push``, the first registry also carries the chunk packs);
``--hasher cpu`` records digests only and never touches the card. Every
build leases a resident session for its context (``worker/session.py``;
``MAKISU_TPU_SESSION=0`` turns them off), so repeated builds in one
process replay untouched sources and cached layers; ``build --watch``
stays resident and rebuilds on every context change. Flags of makisu_tpu
that this package has not ported (remote KV caches, storage budgets,
delta pulls, telemetry outputs, ...) are rejected by the parser. A
device error fails the build: nothing retries on the CPU.
"""

from __future__ import annotations

import argparse
import contextvars
import json
import os
import sys

import makisu_tpu_torch
from makisu_tpu_torch import tario
from makisu_tpu_torch.utils import concurrency, pathutils
from makisu_tpu_torch.utils import logging as log


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
    from makisu_tpu_torch.cache import CacheManager, FSStore
    from makisu_tpu_torch.dockerfile import parse_duration
    if args.local_cache_ttl in ("0", "0s"):
        return None
    ttl = parse_duration(args.local_cache_ttl) / 1e9
    kv = FSStore(os.path.join(store.root, pathutils.CACHE_KV_FILE_NAME), ttl)
    return CacheManager(kv, store, registry_client=registry_client)


def _config_map(args):
    """Per-command registry config map (never the process-global one)."""
    from makisu_tpu_torch.registry import load_config_map
    return (load_config_map(args.registry_config)
            if args.registry_config else None)


def cmd_build(args, device=None) -> int:
    if args.watch:
        return _watch_loop(args, device)
    return _build_once(args, device)


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
        # whose finally releases it.
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
                    ctx, resident_process=args.watch)
                session_mod.set_warm_mode(
                    mode if verdict in ("hit", "restored") else "fresh")
            else:
                session_mod.set_warm_mode("off")
                log.info("build session off (%s)", verdict)
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
        manifest = client.pull(name)
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


def main(argv: list[str] | None = None, device=None) -> int:
    """Run one command; returns its exit code (1 on any failure).

    ``device`` is where the gpu hasher's kernels run: None is the card;
    tests pass ``device="cpu"`` to run the kernels' plain versions.
    """
    parser = make_parser()
    args = parser.parse_args(argv)
    log.configure(args.log_level.replace("warn", "warning"), args.log_fmt,
                  args.log_output)
    if args.command == "version":
        print(makisu_tpu_torch.BUILD_HASH)
        return 0
    handlers = {"build": lambda a: cmd_build(a, device), "pull": cmd_pull,
                "push": cmd_push, "diff": cmd_diff}
    handler = handlers.get(args.command)
    if handler is None:
        parser.print_help()
        return 1
    if args.transfer_concurrency or args.transfer_memory_budget:
        from makisu_tpu_torch.registry import transfer
        transfer.configure(args.transfer_concurrency,
                           args.transfer_memory_budget)

    def run() -> int:
        # Context-scoped worker counts, bound for this command only.
        if args.hash_workers > 0:
            concurrency.set_hash_workers(args.hash_workers)
        if args.compress_workers > 0:
            concurrency.set_compress_workers(args.compress_workers)
        return handler(args)

    try:
        # A fresh context per command: what the command binds (worker
        # counts, the chunk observer) ends with it.
        return contextvars.copy_context().run(run)
    except Exception as e:  # noqa: BLE001 - top-level CLI boundary
        log.error("failed to execute command: %s", e)
        if args.log_level == "debug":
            raise
        return 1


if __name__ == "__main__":
    sys.exit(main())
