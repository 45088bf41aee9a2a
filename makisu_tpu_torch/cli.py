"""makisu-tpu-torch command line: build / version.

    python -m makisu_tpu_torch.cli build CTX -t repo:tag [--hasher gpu|cpu]

Copy of ``makisu_tpu/cli.py``'s ``build`` and ``version`` subcommands
(reference surface: bin/makisu/cmd/ — build flags build.go:97-135).
``--hasher gpu`` (the default, the counterpart of ``--hasher tpu``)
chunks and fingerprints every committed layer on the card and, with a
cache, attaches chunk dedup (``<storage>/chunks/``); ``--hasher cpu``
records digests only and never touches the card. Flags of
makisu_tpu that this package has not ported (registry push, OCI export,
remote caches, storage budgets, watch mode, ...) are rejected by the
parser. A device error fails the build: nothing retries on the CPU.
"""

from __future__ import annotations

import argparse
import contextvars
import os
import sys

import makisu_tpu_torch
from makisu_tpu_torch import tario
from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import pathutils


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
    sub = parser.add_subparsers(dest="command")

    build = sub.add_parser("build", help="build a docker image")
    build.add_argument("context", help="build context directory")
    build.add_argument("-t", "--tag", required=True,
                       help="image tag (repo:tag)")
    build.add_argument("-f", "--file", default="",
                       help="Dockerfile path (default <context>/Dockerfile)")
    build.add_argument("--replica", action="append", default=[],
                       help="additional tags to save")
    build.add_argument("--dest", default="",
                       help="write a docker-save tar here")
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
    build.add_argument("--storage", default="",
                       help="storage directory (default /makisu-storage or "
                            "$HOME fallback)")
    build.add_argument("--compression", default="default",
                       choices=sorted(tario.COMPRESSION_LEVELS))
    build.add_argument("--gzip-backend", default="zlib", choices=["zlib"],
                       help="layer compressor (pgzip is not ported yet)")
    build.add_argument("--preserve-root", action="store_true",
                       help="save and restore the root around the build")
    build.add_argument("--root", default="/",
                       help="build filesystem root (testing)")
    build.add_argument("--hasher", default="gpu", choices=["gpu", "cpu"],
                       help="layer hashing backend: gpu adds content-"
                            "defined chunk fingerprints computed on the "
                            "card; cpu records digests only")

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


def _new_cache_manager(args, store):
    from makisu_tpu_torch.cache import CacheManager, FSStore
    from makisu_tpu_torch.dockerfile import parse_duration
    if args.local_cache_ttl in ("0", "0s"):
        return None
    ttl = parse_duration(args.local_cache_ttl) / 1e9
    kv = FSStore(os.path.join(store.root, pathutils.CACHE_KV_FILE_NAME), ttl)
    return CacheManager(kv, store)


def cmd_build(args, device=None) -> int:
    from makisu_tpu_torch.builder import BuildPlan
    from makisu_tpu_torch.cache import NoopCacheManager
    from makisu_tpu_torch.chunker import get_hasher
    from makisu_tpu_torch.context import BuildContext
    from makisu_tpu_torch.docker.image import ImageName
    from makisu_tpu_torch.dockerfile import parse_file
    from makisu_tpu_torch.storage import ImageStore

    gzip_backend_id = tario.make_backend_id(args.gzip_backend,
                                            args.compression)
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
        cache_mgr = _new_cache_manager(args, store) or NoopCacheManager()
        if args.hasher == "gpu" and not isinstance(cache_mgr,
                                                   NoopCacheManager):
            from makisu_tpu_torch.cache import attach_chunk_dedup
            attach_chunk_dedup(cache_mgr, os.path.join(store.root, "chunks"))
        preserver = None
        if args.preserve_root and args.modifyfs:
            from makisu_tpu_torch.storage.root_preserver import RootPreserver
            preserver = RootPreserver(args.root, store.sandbox_dir,
                                      ctx.blacklist)
        try:
            plan = BuildPlan(ctx, target, replicas, cache_mgr, stages,
                             allow_modify_fs=args.modifyfs,
                             force_commit=(args.commit == "implicit"),
                             stage_target=args.target)
            plan.execute()
        finally:
            if preserver is not None:
                preserver.restore()
        log.info("successfully built image %s", target)
        if args.dest:
            # Lazily served cache hits hold no local blob; the export
            # needs every layer's bytes.
            cache_mgr.materialize_pending()
            from makisu_tpu_torch.docker.save import write_save_tar
            write_save_tar(store, target, args.dest)
            log.info("saved image tar to %s", args.dest)
    log.info("finished building %s", target)
    return 0


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
    if args.command != "build":
        parser.print_help()
        return 1
    try:
        # A fresh context per command: what the build binds (the chunk
        # observer) ends with it.
        return contextvars.copy_context().run(cmd_build, args, device)
    except Exception as e:  # noqa: BLE001 - top-level CLI boundary
        log.error("failed to execute command: %s", e)
        if args.log_level == "debug":
            raise
        return 1


if __name__ == "__main__":
    sys.exit(main())
