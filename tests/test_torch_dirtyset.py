"""Dirty-set rebuilds of the port against the JAX package's, under
adversarial edits.

Counterparts of ``tests/test_dirtyset.py``. The contract: with sessions
on, every build's image equals what the session-less path produces from
the same storage state; the incremental engine may skip only work it can
prove unchanged. Four builders go through each sequence: each package
with sessions on (``resident``) and off (``MAKISU_TPU_SESSION=0``,
``oracle``), each with its own storage. After every edit all four
rebuild: the digests are equal, the two packages' warm modes, dirty sets
and scan-memo entries are equal, and an edit that changes content moves
the digests. The last case does the same with ``--hasher gpu`` on the
CPU device against ``--hasher tpu``, so the chunk lists of an edit
rebuild are compared too, and only the dirty layer commits.
"""

import json
import os
import re
import shutil

import pytest

from makisu_tpu import cli as ref_cli
from makisu_tpu.snapshot import memfs as ref_memfs
from makisu_tpu.worker import session as ref_session
from makisu_tpu_torch import cli
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.utils import mountinfo
from makisu_tpu_torch.worker import session


@pytest.fixture(autouse=True)
def _fresh_sessions(monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE_WINDOW_NS", "0")
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    monkeypatch.setattr(ref_memfs.MemFS, "_sync", lambda self: None)
    mountinfo.set_mountpoints_for_testing(set())
    session.manager().reset()
    ref_session.manager().reset()
    yield
    session.manager().reset()
    ref_session.manager().reset()
    mountinfo.set_mountpoints_for_testing(None)


def _kv(storage):
    """cache id -> entry (the reference's registry ``packs`` dropped)."""
    with open(storage / "cache_key_value.json") as f:
        raw = json.load(f)
    out = {}
    for key, (value, _ts) in raw.items():
        if value.startswith("{"):
            value = json.loads(value)
            value.pop("packs", None)
        out[key] = value
    return out


# The session's line in both packages' logs (its identity differs: the
# storage dir is in it).
_MODE_LINE = re.compile(r"build session \S+: mode=(\w+) dirty=(\d+)")


class _Harness:
    """Four builders over one context: each package with sessions on and
    off, each with its own storage and KV file."""

    BUILDERS = ("port-resident", "port-oracle", "ref-resident",
                "ref-oracle")

    def __init__(self, tmp_path, ctx=None, hasher="cpu") -> None:
        self.tmp = tmp_path
        self.hasher = hasher
        self.ctx = ctx or tmp_path / "ctx"
        if ctx is None:
            (self.ctx / "base").mkdir(parents=True)
            (self.ctx / "src").mkdir()
            (self.ctx / "Dockerfile").write_text(
                "FROM scratch\nCOPY base/ /base/\nCOPY src/ /src/\n")
            for i in range(6):
                (self.ctx / "base" / f"b{i}.txt").write_text(
                    f"base {i}\n" * 20)
                (self.ctx / "src" / f"s{i}.txt").write_text(
                    f"src {i}\n" * 20)
        (tmp_path / "root").mkdir(exist_ok=True)
        self.seq = 0
        self.modes = {"port": [], "ref": []}
        self.logs = {}

    def _one(self, builder: str) -> list[str]:
        package, kind = builder.split("-")
        tag = f"ds/t:{self.seq}"
        storage = self.tmp / builder
        log = self.tmp / f"{builder}-{self.seq}.log"
        self.logs[builder] = log
        argv = ["--log-fmt", "json", "--log-output", str(log), "build",
                str(self.ctx), "-t", tag, "--storage", str(storage),
                "--root", str(self.tmp / "root")]
        hasher = ({"gpu": "tpu"}.get(self.hasher, self.hasher)
                  if package == "ref" else self.hasher)
        argv += ["--hasher", hasher]
        before = os.environ.get("MAKISU_TPU_SESSION")
        if kind == "oracle":
            os.environ["MAKISU_TPU_SESSION"] = "0"
        try:
            if package == "port":
                code = cli.main(argv, device="cpu")
            else:
                code = ref_cli.main(argv)
        finally:
            if before is None:
                os.environ.pop("MAKISU_TPU_SESSION", None)
            else:
                os.environ["MAKISU_TPU_SESSION"] = before
        assert code == 0, builder
        with open(storage / "manifests" / "ds" / "t" /
                  f"{self.seq}.json") as f:
            return [l["digest"] for l in json.load(f)["layers"]]

    def build_all(self) -> list[str]:
        """All four builders; the digests agree. Records each package's
        resident warm mode and dirty set."""
        self.seq += 1
        digests = {}
        for builder in self.BUILDERS:
            dirty = self.session_state(builder.split("-")[0])
            digests[builder] = self._one(builder)
            if builder.endswith("resident"):
                mode, = [m.groups() for m in map(
                    _MODE_LINE.match, self.messages(builder)) if m]
                self.modes[builder.split("-")[0]].append(
                    (mode[0], int(mode[1]), dirty))
        assert len({tuple(d) for d in digests.values()}) == 1, digests
        assert self.modes["port"] == self.modes["ref"]
        port, ref = self.session("port"), self.session("ref")
        assert port.scan_memo == ref.scan_memo
        assert sorted(port.layer_replay) == sorted(ref.layer_replay)
        if self.hasher == "gpu":
            assert _kv(self.tmp / "port-resident") == \
                _kv(self.tmp / "ref-resident")
        return digests["port-resident"]

    def session(self, package):
        mod = session if package == "port" else ref_session
        return mod.manager().peek(str(self.ctx))

    def session_state(self, package):
        """The pending dirty set (context-relative) before a build."""
        s = self.session(package)
        if s is None:
            return None
        return sorted(os.path.relpath(p, self.ctx) for p in s.pending_dirty)

    def messages(self, builder):
        return [json.loads(line)["msg"] for line in
                self.logs[builder].read_text().splitlines()]


def test_adversarial_edit_matrix(tmp_path):
    h = _Harness(tmp_path)
    baseline = h.build_all()
    warm = h.build_all()  # no edit: resident reuse, same digests
    assert warm == baseline
    assert h.session("port").hits >= 1

    # 1. mtime-only touch: the stat moves, the content does not. Cache
    # identity is content-based, so the digests must not move.
    victim = h.ctx / "src" / "s2.txt"
    st = os.lstat(victim)
    os.utime(victim, ns=(st.st_atime_ns + 7_000_000_000,
                         st.st_mtime_ns + 7_000_000_000))
    touched = h.build_all()
    assert touched == baseline

    # 2. a content change with the same size and a restored mtime (the
    # racy aliasing attempt): ctime always moves, so the edit is seen.
    st = os.lstat(victim)
    original = victim.read_bytes()
    flipped = bytes(reversed(original))
    assert len(flipped) == len(original) and flipped != original
    victim.write_bytes(flipped)
    os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert os.lstat(victim).st_mtime_ns == st.st_mtime_ns
    edited = h.build_all()
    assert edited != touched, "same-size/same-mtime edit was missed"

    # 3a. delete of a mid-layer file; 3b. rename of one.
    (h.ctx / "src" / "s4.txt").unlink()
    deleted = h.build_all()
    assert deleted != edited
    os.rename(h.ctx / "src" / "s5.txt", h.ctx / "src" / "s5-new.txt")
    renamed = h.build_all()
    assert renamed != deleted

    # 4. the untouched base/ replays from the scan memo.
    assert h.session("port").scan_memo, "scan memo never populated"
    assert "replaying resident layer" in " ".join(
        h.messages("port-resident"))

    # 5. a new file appears.
    (h.ctx / "src" / "brand-new.txt").write_text("fresh\n")
    added = h.build_all()
    assert added != renamed
    assert [m[0] for m in h.modes["port"]] == ["rescan"] + ["resident"] * 6


def test_dockerignore_masked_edits(tmp_path):
    h = _Harness(tmp_path)
    (h.ctx / ".dockerignore").write_text("src/ignored.log\n")
    (h.ctx / "src" / "ignored.log").write_text("noise 1\n")
    baseline = h.build_all()

    # Editing an ignored file changes nothing (the dirty set flags it;
    # the walk proves it inert).
    (h.ctx / "src" / "ignored.log").write_text("noise 2 louder\n")
    masked = h.build_all()
    assert masked == baseline

    # Changing .dockerignore itself bears identity: the session drops
    # its scan memo rather than replaying stale transitions.
    (h.ctx / ".dockerignore").write_text("# nothing ignored now\n")
    unmasked = h.build_all()
    assert unmasked != baseline


def test_dir_rename_above_source_invalidates_memo(tmp_path):
    """Renaming an ancestor of a COPY source events only the moved
    directory: a dirty ancestor must invalidate, or the scan memo replays
    a checksum of a tree that is gone."""
    ctx = tmp_path / "ctx"
    (ctx / "outer" / "inner").mkdir(parents=True)
    (ctx / "Dockerfile").write_text(
        "FROM scratch\nCOPY outer/inner/ /app/\n")
    (ctx / "outer" / "inner" / "f.txt").write_text("original\n")
    h = _Harness(tmp_path, ctx=ctx)
    baseline = h.build_all()
    warm = h.build_all()  # the session is resident with a memo
    assert warm == baseline
    os.rename(ctx / "outer", ctx / "moved-away")
    (ctx / "outer" / "inner").mkdir(parents=True)
    (ctx / "outer" / "inner" / "f.txt").write_text("replaced\n")
    renamed = h.build_all()
    assert renamed != baseline, \
        "ancestor rename was invisible: stale scan memo replayed"


def test_session_survives_deleted_then_recreated_tree(tmp_path):
    """Deleting a source tree between builds must not wedge or stale the
    session."""
    h = _Harness(tmp_path)
    baseline = h.build_all()
    src = h.ctx / "src"
    shutil.rmtree(src)
    src.mkdir()
    for i in range(3):
        (src / f"n{i}.txt").write_text(f"regenerated {i}\n")
    rebuilt = h.build_all()
    assert rebuilt != baseline
    again = h.build_all()
    assert again == rebuilt


def test_failed_build_makes_the_next_one_rescan(tmp_path):
    """A failing build (a COPY source gone) clears the memo and the dirty
    knowledge in both packages; the next build scans everything and
    equals the oracles."""
    h = _Harness(tmp_path)
    baseline = h.build_all()
    h.build_all()
    shutil.rmtree(h.ctx / "base")
    for mod, main, name in (
            (session, lambda a: cli.main(a, device="cpu"), "port"),
            (ref_session, ref_cli.main, "ref")):
        code = main(["--log-level", "error", "build", str(h.ctx), "-t",
                     "ds/fail:1", "--hasher", "cpu", "--storage",
                     str(tmp_path / f"{name}-resident"), "--root",
                     str(tmp_path / "root")])
        assert code == 1
        s = mod.manager().peek(str(h.ctx))
        assert s.builds == 3 and not s.exact and not s.scan_memo
    (h.ctx / "base").mkdir()
    (h.ctx / "base" / "b0.txt").write_text("base 0\n" * 20)
    after = h.build_all()
    assert after != baseline
    assert h.modes["port"][-1][0] == "rescan"


def test_gpu_edit_rebuild_commits_only_the_dirty_layer(tmp_path):
    """``--hasher gpu`` on the CPU device against ``--hasher tpu``: a
    one-file edit in the last of three COPY sources commits that layer
    alone, the other sources replay from the scan memo and their layers
    from the replay memo, and the KV entries (chunk lists included)
    equal the reference's."""
    ctx = tmp_path / "ctx"
    lines = ["FROM scratch"]
    for k in range(3):
        (ctx / f"shard{k}").mkdir(parents=True)
        for i in range(4):
            (ctx / f"shard{k}" / f"f{i}.txt").write_bytes(
                bytes((k * 31 + i * 7 + j) % 251 for j in range(3000)))
        lines.append(f"COPY shard{k}/ /app/shard{k}/")
    (ctx / "Dockerfile").write_text("\n".join(lines) + "\n")
    h = _Harness(tmp_path, ctx=ctx, hasher="gpu")
    h.BUILDERS = ("port-resident", "ref-resident")
    cold = h.build_all()
    h.build_all()
    with open(ctx / "shard2" / "f1.txt", "ab") as f:
        f.write(b"sixteen byte tail")
    edited = h.build_all()
    assert edited[:2] == cold[:2] and edited[2] != cold[2]
    msgs = h.messages("port-resident")
    assert len([m for m in msgs if m.startswith("committed layer")]) == 1
    assert len([m for m in msgs
                if m.startswith("replaying resident layer")]) == 2
    recs = [json.loads(line) for line in
            h.logs["port-resident"].read_text().splitlines()]
    tallies = [r for r in recs if r["msg"].startswith("stat cache for")]
    assert [t["memo_sources"] for t in tallies] == [1, 1, 0]
    assert [t["misses"] for t in tallies] == [0, 0, 1]
    assert h.modes["port"][-1][:2] == ("resident", 1)


def test_replay_memo_records_from_the_chunk_route(tmp_path):
    """``--hasher gpu`` against ``--hasher tpu``: with every layer blob
    deleted after the cold build, the next build applies each layer from
    its chunks and records it; the one after replays it and opens no
    chunk stream. Images and replay keys equal the reference's."""
    ctx = tmp_path / "ctx"
    (ctx / "a").mkdir(parents=True)
    (ctx / "b").mkdir()
    for i in range(3):
        (ctx / "a" / f"f{i}").write_bytes(bytes(range(i, 256)) * 9)
        (ctx / "b" / f"g{i}").write_bytes(bytes(range(255, i, -1)) * 7)
    (ctx / "Dockerfile").write_text(
        "FROM scratch\nCOPY a/ /a/\nCOPY b/ /b/\n")
    h = _Harness(tmp_path, ctx=ctx, hasher="gpu")
    h.BUILDERS = ("port-resident", "ref-resident")
    cold = h.build_all()
    for builder in h.BUILDERS:
        for digest in cold:
            hexd = digest.split(":")[1]
            os.unlink(tmp_path / builder / "layers" / hexd[:2] / hexd)
    assert h.build_all() == cold
    for builder in h.BUILDERS:
        msgs = h.messages(builder)
        assert len([m for m in msgs if m.startswith("applying layer ")
                    and m.endswith("chunks (no blob, no gzip)")]) == 2
    assert len(h.session("port").layer_replay) == 2
    assert h.build_all() == cold
    for builder in h.BUILDERS:
        msgs = h.messages(builder)
        assert not [m for m in msgs if m.startswith("applying layer ")]
        assert len([m for m in msgs
                    if m.startswith("replaying resident layer")]) == 2
