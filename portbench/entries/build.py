"""Entry ``build``: one ``makisu build`` of the configuration's context
through ``makisu_tpu_torch.cli.main``, with ``--hasher gpu``, each build
with a fresh ``SessionManager`` as a build process of its own would have.

Modes (the cell's ``mode``):

- ``cold``: every build goes into a fresh storage and root; before each,
  the context's first file gets the iteration as its mtime, so no two
  builds' layers are the same.
- ``edit``: set-up builds the context once, cold, into one storage; each
  iteration first appends 16 bytes to 1% of the files of the cell's
  ``edit_dir`` (picked by a generator seeded from the seed and the
  iteration), then builds again into a fresh root and the same storage.

With ``"kv": "redis"`` the builds share the benchmark's RESP double (a
process of its own, ``portbench/respdouble.py``) through
``--redis-cache-addr`` and ``--redis-cache-password``.

Judged, for the cold set-up build and a sample of the window's builds
drawn from the seed (the last always among them): each layer's files
against the context as it stood at that build, the manifest's layer
digests and the config's diff_ids against the blobs, each blob's bytes
against the reference gzip, the KV entry's chunk list (cut ends, every
chunk's SHA-256) against the reference, which layers were committed and
which hit, and at the end the chunk store's files.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

from portbench import gen, logphases
from portbench.reference import judge, layers

SAMPLE = 3  # window builds judged in full (the last and two drawn)


def _resp(sock, *parts: bytes):
    """One RESP2 command and its reply (bulk, array, simple or error)."""
    sock.sendall(b"*%d\r\n" % len(parts) + b"".join(
        b"$%d\r\n%s\r\n" % (len(p), p) for p in parts))
    f = sock.makefile("rb")

    def reply():
        line = f.readline().rstrip(b"\r\n")
        kind, rest = line[:1], line[1:]
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = f.read(n + 2)[:n]
            return data
        if kind == b"*":
            return [reply() for _ in range(int(rest))]
        if kind == b"-":
            raise RuntimeError(rest.decode())
        return rest

    return reply()


def read_kv(addr: str, password: str) -> list[str]:
    """Every value the RESP double holds."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=30) as sock:
        _resp(sock, b"AUTH", password.encode())
        keys = _resp(sock, b"KEYS", b"*")
        return [_resp(sock, b"GET", k).decode() for k in keys]


def file_kv(storage: str) -> list[str]:
    with open(os.path.join(storage, "cache_key_value.json")) as f:
        return [value for value, _ts in json.load(f).values()]


def layer_entries(values) -> dict[str, dict]:
    """gzip digest -> cache entry of every layer among KV values."""
    return {e["gzip"]: e for e in (json.loads(v) for v in values
                                   if v.startswith("{"))}


class Entry:
    # Each build's phases, printed on standard error.
    SUMMARY = ("plan_s", "commit_s", "sync_s", "diff_s", "compress_s",
               "session_s", "index_s", "apply_s")

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        cfg = dict(ctx.config)
        cfg["context_bytes"] = ctx.traffic.get("context_bytes",
                                               cfg["context_bytes"])
        self.cfg = cfg
        self.mode = ctx.traffic["mode"]
        self.work = ctx.work
        self.context = os.path.join(self.work, "context")
        self.shared = os.path.join(self.work, "storage")
        self.kv = None        # the RESP double's process
        self.kv_addr = None
        self.password = f"portbench-{ctx.seed}"
        self.builds: list[dict] = []   # set-up builds, judged too
        self.edits: dict[str, int] = {}  # path -> appends so far

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        self.files = gen.context_files(self.cfg, self.ctx.seed)
        self.dockerfile = gen.dockerfile(self.cfg)
        os.makedirs(self.context)
        gen.write_context(self.context, self.files, self.dockerfile)
        if self.cfg.get("kv") == "redis":
            self.kv = subprocess.Popen(
                [sys.executable, os.path.join(os.path.dirname(
                    os.path.dirname(__file__)), "respdouble.py"),
                 "--password", self.password],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            self.kv_addr = self.kv.stdout.readline().strip()
            if not self.kv_addr:
                raise RuntimeError("the RESP double did not start")
        if self.mode == "edit":
            rec = self._build("v1", self.shared)
            rec["edits"] = {}
            self.builds.append(rec)

    # -- one build ------------------------------------------------------------

    def _argv(self, tag: str, storage: str, root: str, log: str) -> list:
        argv = ["--log-fmt", "json", "--log-output", log, "build",
                self.context, "-t", tag, "--hasher", "gpu", "--storage",
                storage, "--root", root, *self.cfg.get("build_flags", ()),
                *self.ctx.traffic.get("build_flags", ())]
        if self.kv_addr:
            argv += ["--redis-cache-addr", self.kv_addr,
                     "--redis-cache-password", self.password]
        return argv

    def _build(self, name: str, storage: str) -> dict:
        from makisu_tpu_torch import cli
        from makisu_tpu_torch.worker import session

        root = os.path.join(self.work, f"root-{name}")
        log = os.path.join(self.work, f"log-{name}.jsonl")
        os.makedirs(root)
        tag = f"bench/app:{name}"
        manager = session.SessionManager()
        token = session.bind_manager(manager)
        start = time.time()
        try:
            with self.ctx.spans.span("build: cli.main"):
                rc = cli.main(self._argv(tag, storage, root, log),
                              device=None if self.ctx.device == "cuda"
                              else self.ctx.device)
        finally:
            session.reset_manager(token)
            manager.reset()
        end = time.time()
        records = logphases.read_log(log)
        if rc != 0:
            errors = [r["msg"] for r in records if r["level"] == "error"]
            raise RuntimeError(f"build {name} exited {rc}: {errors}")
        # The manifest as the build left it: the storage keeps the 16
        # newest (upstream's LRU), so a window of more builds evicts the
        # first ones' before the judge reads them.
        repo, _, tag_name = tag.rpartition(":")
        with open(os.path.join(storage, "manifests", repo,
                               tag_name + ".json")) as f:
            manifest = json.load(f)
        return {"name": name, "tag": tag, "storage": storage, "start": start,
                "end": end, "log": records, "manifest": manifest,
                **logphases.phases(records, start)}

    def iterate(self, i: int) -> dict:
        name = "warm" if i < 0 else str(i)
        if self.mode == "edit":
            edit_dir = self.ctx.traffic["edit_dir"]
            with self.ctx.spans.span("edit: append to 1% of the files"):
                picked = gen.append_to_one_percent(
                    os.path.join(self.context, edit_dir),
                    [self.ctx.seed, i + 1])
            for rel in picked:
                path = f"{edit_dir}/{rel}"
                self.edits[path] = self.edits.get(path, 0) + 1
            storage = self.shared
        else:
            # Each cold build's context differs from the one before in one
            # file's mtime, so its layer's tar and digests do too.
            stamp = gen.CONTEXT_MTIME + i + 1
            os.utime(os.path.join(self.context, self.files[0][0]),
                     (stamp, stamp))
            storage = os.path.join(self.work, f"storage-{name}")
        rec = self._build(name, storage)
        rec["edits"] = dict(self.edits)
        if i < 0 and self.mode == "cold":
            shutil.rmtree(storage, ignore_errors=True)
        return rec

    def host_intervals(self, records) -> list:
        out = list(self.ctx.spans.items)
        for rec in records:
            out += logphases.intervals(rec["log"], rec["start"], rec["end"])
        return out

    def release(self) -> None:
        pass

    # -- the judge -------------------------------------------------------------

    def _context_at(self, edits: dict) -> dict[str, bytes]:
        files = {path: content for path, content in self.files}
        for path, times in edits.items():
            files[path] = files[path] + gen.EDIT_BYTES * times
        files["Dockerfile"] = self.dockerfile.encode()
        return files

    def _kv_values(self, storage: str) -> list[str]:
        if self.kv_addr:
            return read_kv(self.kv_addr, self.password)
        return file_kv(storage)

    def _judge_build(self, rec: dict, entries: dict, counts: dict,
                     expect: dict) -> set[str]:
        storage = rec["storage"]
        manifest = rec["manifest"]
        cfg_hex = manifest["config"]["digest"].split(":")[1]
        with open(os.path.join(storage, "layers", cfg_hex[:2], cfg_hex),
                  "rb") as f:
            diff_ids = json.load(f)["rootfs"]["diff_ids"]
        want_layers = layers.copy_layers(self.dockerfile,
                                         self._context_at(rec["edits"]))
        descs = manifest["layers"]
        counts["layer_count"] += abs(len(descs) - len(want_layers)) + \
            abs(len(diff_ids) - len(descs))
        chunk_ids = set()
        for desc, diff_id, want in zip(descs, diff_ids, want_layers):
            hexd = desc["digest"].split(":")[1]
            with open(os.path.join(storage, "layers", hexd[:2], hexd),
                      "rb") as f:
                blob = f.read()
            tar = gzip.decompress(blob)
            counts["layer_digests"] += int(
                layers.sha256_hex(blob) != hexd or len(blob) != desc["size"]
                or "sha256:" + layers.sha256_hex(tar) != diff_id)
            counts["layer_files"] += layers.file_mismatches(
                layers.regular_files(tar), want)
            entry = entries.get(desc["digest"])
            if entry is None or entry.get("tar") != diff_id:
                counts["kv_entries"] += 1
                continue
            counts["blob_bytes"] += int(blob != layers.blob_for(
                tar, entry["gz"]))
            chunks = [tuple(c) for c in entry["chunks"]]
            if self.ctx.control_block:
                chunks = judge.control_chunks(tar, self.cfg["chunking"],
                                              self.ctx.device,
                                              self.ctx.control_block)
            chunk_ids.update(h for _, _, h in chunks)
            got = judge.chunk_counts(tar, chunks, judge.want_ends(
                tar, self.cfg["chunking"], self.ctx.device))
            judge.add(counts, got)
        counts["hit_pattern"] += abs(rec["committed"] - expect["committed"]) \
            + abs(rec["hits"] - expect["hits"])
        return chunk_ids

    def judge(self, records) -> dict:
        counts = {k: 0 for k in (
            "layer_count", "layer_digests", "layer_files", "blob_bytes",
            "kv_entries", "cut_ends", "chunk_digests", "untiled",
            "hit_pattern", "cas_files")}
        rng = np.random.default_rng([self.ctx.seed, 7])
        pick = {len(records) - 1}
        if len(records) > 1:
            pick.update(rng.choice(len(records) - 1,
                                   size=min(SAMPLE - 1, len(records) - 1),
                                   replace=False).tolist())
        sample = [(r, self.ctx.traffic["expect"]) for k, r in
                  enumerate(records) if k in pick]
        if self.mode == "edit":
            n_layers = len(layers.copy_layers(self.dockerfile, {}))
            sample.insert(0, (self.builds[0], {"committed": n_layers,
                                               "hits": 0}))
        for rec, expect in sample:
            entries = layer_entries(self._kv_values(rec["storage"]))
            self._judge_build(rec, entries, counts, expect)
        # The chunk store of the last build's storage holds exactly the
        # chunks of the layers its KV lists, each under its own digest.
        storage = records[-1]["storage"]
        want = set()
        for entry in layer_entries(self._kv_values(storage)).values():
            want.update(h for _, _, h in entry["chunks"])
        cas = os.path.join(storage, "chunks")
        have = set()
        for shard in os.listdir(cas):
            if shard.startswith("_"):
                continue
            for name in os.listdir(os.path.join(cas, shard)):
                with open(os.path.join(cas, shard, name), "rb") as f:
                    ok = layers.sha256_hex(f.read()) == name and \
                        shard == name[:2]
                counts["cas_files"] += int(not ok)
                have.add(name)
        counts["cas_files"] += len(have ^ want)
        return judge.limits(counts)

    def close(self) -> None:
        if self.kv is not None:
            self.kv.stdin.close()
            try:
                self.kv.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.kv.kill()
                self.kv.wait()
            self.kv.stdout.close()
            self.kv = None
