"""One layer commit from files through the port's layer sinks, in turns.

    python -m makisu_tpu_torch.tools.commit_variants [--mib 1024]
        [--backend pgzip-6-131072] [--device cuda|cpu]   # from the repo root

Writes ``chip_smoke.py``'s config-3 context (``write_context``: text-like
files of 1-64 KiB, one in seven a repeat, to 75% of the bytes, then 4-16
MiB binaries) into a temp dir, makes the COPY layer of its files as the
snapshot does (``tarinfo_from_stat``, sorted paths, no tree diff), and
commits it into a temp file in each variant, in turns (the list, then
the list reversed), each with its own chunk session:

- ``native``: ``NativeLayerSink`` with the session as its tap and the
  read-ahead in warm mode (each upcoming file read and discarded in a
  task on the commit pool), as a build commits;
- ``native_serial``: the same without the read-ahead;
- ``python``: the Python sink (``_GPUSink``), serial;
- ``python_buffer``: the Python sink fed the read-ahead's bytes.

Prints one JSON line per commit: wall seconds, process CPU seconds, the
seconds inside the C++ pipeline and in its tap (native), the session's
host seconds, and the blob digest, which must be one for all variants.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import tempfile
import time

import numpy as np

import chip_smoke as cs
from makisu_tpu_torch.chunker import hasher
from makisu_tpu_torch.chunker.cdc import ChunkSession
from makisu_tpu_torch.snapshot.layer import Layer
from makisu_tpu_torch.snapshot.walk import tarinfo_from_stat
from makisu_tpu_torch.utils import concurrency

VARIANTS = ("native", "native_serial", "python", "python_buffer")


def make_layer(ctx: str) -> Layer:
    layer = Layer()
    for dirpath, dirs, files in os.walk(ctx):
        dirs.sort()
        for name in sorted(dirs + files):
            src = os.path.join(dirpath, name)
            dst = "/app/" + os.path.relpath(src, ctx)
            layer.add_header(src, dst, tarinfo_from_stat(src, dst[1:], "/"))
    return layer


def commit(layer, variant: str, backend_id: str, device, out_path: str
           ) -> dict:
    session = ChunkSession(device=device)
    workers = 1 if variant in ("native_serial", "python") else \
        concurrency.hash_workers()
    with open(out_path, "wb") as out:
        t0, c0 = time.perf_counter(), time.process_time()
        if variant.startswith("native"):
            sink = hasher.NativeLayerSink(out, backend_id, session=session)
        else:
            sink = hasher._GPUSink(out, session, backend_id)
        with sink.open_tar() as tw:
            layer.commit(tw, workers=workers)
        result = sink.finish()
        wall_s = time.perf_counter() - t0
        cpu_s = time.process_time() - c0
    row = {"variant": variant, "backend_id": backend_id,
           "workers": workers, "wall_s": wall_s, "cpu_s": cpu_s,
           "gzip": result.digest_pair.gzip_descriptor.digest.hex(),
           "chunks": len(result.chunks), "session_s": session.host_seconds}
    if variant.startswith("native"):
        row.update(native_s=sink.handle.native_seconds,
                   tap_s=sink.handle.tap_seconds)
    with open(out_path, "rb") as f:
        row["blob_ok"] = hashlib.sha256(f.read()).hexdigest() == row["gzip"]
    os.unlink(out_path)
    return row


def main() -> None:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--mib", type=int, default=1024)
    parser.add_argument("--backend", default="pgzip-6-131072")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args()
    device = torch.device(args.device)
    variants = args.variants.split(",")
    work = tempfile.mkdtemp(prefix="commit-variants-")
    try:
        ctx = os.path.join(work, "ctx")
        t0 = time.perf_counter()
        nfiles, nbytes = cs.write_context(np, ctx, args.mib * cs.MIB)
        print(json.dumps({"files": nfiles, "bytes": nbytes,
                          "write_context_s": time.perf_counter() - t0,
                          "hash_workers": concurrency.hash_workers(),
                          "compress_workers":
                          concurrency.compress_workers()}), flush=True)
        layer = make_layer(ctx)
        digests = set()
        for variant in variants + variants[::-1]:
            row = commit(layer, variant, args.backend, device,
                         os.path.join(work, "blob.gz"))
            digests.add(row["gzip"])
            print(json.dumps(row), flush=True)
        print(json.dumps({"one_blob": len(digests) == 1}), flush=True)
        if len(digests) != 1:
            raise SystemExit("the variants wrote different blobs")
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
