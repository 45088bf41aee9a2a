"""The port's session snapshots against the JAX package's.

Counterparts of ``tests/test_session_snapshot.py`` (without the worker's
snapshot endpoints and the storage census, which wait for the port's
worker and storage governance): the checkpoint on ``finish_build``, the
restore on a cold acquire with its invalidations (flag identity, kernel
route, staleness), digest identity under a stale restored stat cache,
the scan memo's recency order and the ``lru_restore`` label. Each
sequence runs through both CLIs with ``--hasher cpu``; the two
packages' recipes and shard documents are compared, and a restore
across packages is refused with the reference's own reason
(``isa_change``) or, with the routes aligned, works.
"""

import json
import os
import time

import pytest

from makisu_tpu import cli as ref_cli
from makisu_tpu.snapshot import memfs as ref_memfs
from makisu_tpu.worker import session as ref_session
from makisu_tpu.worker import snapshots as ref_snapshots
from makisu_tpu_torch import cli
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.utils import mountinfo
from makisu_tpu_torch.worker import session, snapshots

MODS = {"port": (session, snapshots), "ref": (ref_session, ref_snapshots)}


@pytest.fixture(autouse=True)
def _fresh_sessions(monkeypatch):
    """Empty session registries, the window-0 racy discipline, and the
    snapshot plane forced on (one-shot builds are not resident, so the
    auto policy would skip the checkpoints these tests check)."""
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE_WINDOW_NS", "0")
    monkeypatch.setenv("MAKISU_TPU_SESSION_SNAPSHOT", "1")
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    monkeypatch.setattr(ref_memfs.MemFS, "_sync", lambda self: None)
    mountinfo.set_mountpoints_for_testing(set())
    session.manager().reset()
    ref_session.manager().reset()
    yield
    session.manager().reset()
    ref_session.manager().reset()
    mountinfo.set_mountpoints_for_testing(None)


def _make_ctx(tmp_path, name="ctx"):
    ctx = tmp_path / name
    (ctx / "src").mkdir(parents=True)
    (ctx / "Dockerfile").write_text(
        "FROM scratch\nCOPY src/ /src/\nCOPY top.txt /top.txt\n")
    for i in range(4):
        (ctx / "src" / f"m{i}.py").write_text(f"# {i}\n" + "x=1\n" * 50)
    (ctx / "top.txt").write_text("top")
    (tmp_path / "root").mkdir(exist_ok=True)
    return ctx


def _build(tmp_path, ctx, tag, package, storage=None):
    storage = tmp_path / (storage or f"storage-{package}")
    argv = ["--log-level", "error", "build", str(ctx), "-t", tag,
            "--hasher", "cpu", "--storage", str(storage), "--root",
            str(tmp_path / "root")]
    code = (cli.main(argv, device="cpu") if package == "port"
            else ref_cli.main(argv))
    assert code == 0
    repo, t = tag.split(":")
    with open(storage / "manifests" / repo / f"{t}.json") as f:
        return [l["digest"] for l in json.load(f)["layers"]]


def _both(tmp_path, ctx, tag, **kw):
    port = _build(tmp_path, ctx, tag, "port", **kw)
    assert port == _build(tmp_path, ctx, tag, "ref", **kw)
    return port


def _recipes(storage):
    snapdir = storage / "serve" / "snapshots"
    if not snapdir.is_dir():
        return []
    return [json.loads((snapdir / n).read_text())
            for n in sorted(os.listdir(snapdir)) if n.endswith(".json")]


def _shards(storage, recipe):
    """Shard name -> its document, read from the storage's chunk CAS."""
    out = {}
    for name, row in recipe["shards"].items():
        h = row["chunk"]
        data = (storage / "chunks" / h[:2] / h).read_bytes()
        assert len(data) == row["bytes"]
        out[name] = json.loads(data)
    return out


def _stat_rows(shards):
    """Stat shards without each entry's hash time (the moment of the
    build's read, which differs between the two builds)."""
    return {name: {rel: entry[:2] for rel, entry in doc.items()}
            for name, doc in shards.items() if name.startswith("stat/")}


# -- scan-memo LRU ----------------------------------------------------------


def test_scan_memo_trim_is_recency_ordered(tmp_path, monkeypatch):
    """A hot key replayed every build outlives a burst of one-shot keys:
    lookups bump recency, and the trim evicts the least recently stored
    or replayed key."""
    out = []
    for mod, _ in MODS.values():
        monkeypatch.setattr(mod, "_SCAN_MEMO_KEEP", 4)
        s = mod.BuildSession(str(tmp_path), "id")
        for i in range(4):
            s.scan_store(f"src{i}", i, i, 1, 1)
        assert s.scan_lookup("src0", 0) is not None
        s.scan_store("src4", 4, 4, 1, 1)
        out.append([list(s.scan_memo), s.scan_lookup("src0", 0),
                    s.scan_lookup("src1", 1)])
    assert out[0] == out[1]
    assert out[0][1] is not None and out[0][2] is None


# -- checkpoint and restore round trip --------------------------------------


def test_finish_build_checkpoints_and_cold_acquire_restores(tmp_path):
    ctx = _make_ctx(tmp_path)
    d1 = _both(tmp_path, ctx, "snap/t:1")
    d2 = _both(tmp_path, ctx, "snap/t:2")
    assert d1 == d2
    got = {}
    for package, (mod, snap_mod) in MODS.items():
        recipes = _recipes(tmp_path / f"storage-{package}")
        assert len(recipes) == 1
        recipe = recipes[0]
        assert recipe["schema"] == snap_mod.SNAPSHOT_SCHEMA
        assert recipe["context"] == os.path.realpath(str(ctx))
        assert "scan" in recipe["shards"]
        assert mod.manager().snapshot_counts.get("write", 0) == 2
        got[package] = recipe
    # The recipes agree on all but the storage-bearing identity, the
    # kernel/ISA route, the capture times and the shards that hold them
    # (compared on their own below).
    volatile = ("identity", "isa", "saved_at", "walk", "shards")
    assert {k: v for k, v in got["port"].items() if k not in volatile} \
        == {k: v for k, v in got["ref"].items() if k not in volatile}
    assert snapshots.SNAPSHOT_SCHEMA == ref_snapshots.SNAPSHOT_SCHEMA
    assert snapshots.snap_key(str(ctx), "p") == \
        ref_snapshots.snap_key(str(ctx), "p")

    # The kill -9 model: every resident session dies with the process;
    # only the checkpoint survives.
    for mod, _ in MODS.values():
        mod.manager().reset()
    d3 = _both(tmp_path, ctx, "snap/t:3")
    assert d3 == d1
    for mod, _ in MODS.values():
        assert mod.manager().snapshot_counts.get("restore", 0) == 1
        s = mod.manager().peek(str(ctx))
        assert s is not None and s.builds >= 3


def test_shard_documents_match_the_reference(tmp_path):
    """Both packages build the same context into their own storage: the
    scan, walk and layer shards are the same documents (the same
    chunks), and the stat shards the same entries but for their hash
    times."""
    ctx = _make_ctx(tmp_path)
    _both(tmp_path, ctx, "doc/t:1")
    _both(tmp_path, ctx, "doc/t:2")
    shards = {}
    recipes = {}
    for package in MODS:
        storage = tmp_path / f"storage-{package}"
        (recipe,) = _recipes(storage)
        recipes[package] = recipe
        shards[package] = _shards(storage, recipe)
    port, ref = shards["port"], shards["ref"]
    assert sorted(port) == sorted(ref)
    plain = [n for n in port if not n.startswith("stat/")]
    assert {n for n in plain if n.startswith("layer/")}
    assert {n for n in plain if n.startswith("walk/")}
    for name in plain:
        assert port[name] == ref[name], name
        assert recipes["port"]["shards"][name] == \
            recipes["ref"]["shards"][name]
    assert _stat_rows(port) == _stat_rows(ref)
    assert recipes["port"]["layer_keys"] == recipes["ref"]["layer_keys"]
    walk_docs = [dict(recipes[p]["walk"], captured_ns=0) for p in MODS]
    assert walk_docs[0] == walk_docs[1]


def test_incremental_checkpoint_rewrites_only_dirty_shards(tmp_path):
    """An edit re-serializes the scan shard and the stat and walk buckets
    holding the edited file; every other shard carries its chunk."""
    ctx = _make_ctx(tmp_path)
    _both(tmp_path, ctx, "inc/t:1")
    _both(tmp_path, ctx, "inc/t:2")
    before = {p: _recipes(tmp_path / f"storage-{p}")[0] for p in MODS}
    (ctx / "src" / "m2.py").write_text("# edited\n")
    _both(tmp_path, ctx, "inc/t:3")
    moved = {}
    for package in MODS:
        after = _recipes(tmp_path / f"storage-{package}")[0]
        old = before[package]["shards"]
        moved[package] = sorted(
            n for n, row in after["shards"].items()
            if old.get(n) != row and not n.startswith("layer/"))
    assert moved["port"] == moved["ref"]
    assert "scan" in moved["port"]
    assert len([n for n in moved["port"] if n.startswith("stat/")]) == 1


# -- restore refusals -------------------------------------------------------


def test_restore_refused_on_flag_identity_change(tmp_path):
    ctx = _make_ctx(tmp_path)
    _both(tmp_path, ctx, "snap/fi:1")
    for package, (mod, _) in MODS.items():
        mgr = mod.manager()
        mgr.reset()
        storage = str(tmp_path / f"storage-{package}")
        s, verdict = mgr.acquire(str(ctx), "other-identity",
                                 restore_spec=(storage, "other-portable"))
        assert verdict == "miss"   # a cold create, never a silent replay
        assert mgr.snapshot_counts.get("restore_refused", 0) == 1
        assert mgr.last_restore_failure["reason"] == "flag_identity"
        mgr.release(s)


def test_restore_refused_on_isa_change(tmp_path, monkeypatch):
    ctx = _make_ctx(tmp_path)
    _both(tmp_path, ctx, "snap/isa:1")
    for package, (mod, _) in MODS.items():
        (recipe,) = _recipes(tmp_path / f"storage-{package}")
        mgr = mod.manager()
        mgr.reset()
        monkeypatch.setattr(mod, "_isa_identity",
                            lambda: "a-route-from-elsewhere")
        s, verdict = mgr.acquire(
            str(ctx), "id", restore_spec=(
                str(tmp_path / f"storage-{package}"),
                recipe["portable_identity"]))
        assert verdict == "miss"
        assert mgr.last_restore_failure["reason"] == "isa_change"
        mgr.release(s)


def test_restore_refused_on_stale_snapshot(tmp_path, monkeypatch):
    ctx = _make_ctx(tmp_path)
    _both(tmp_path, ctx, "snap/ttl:1")
    monkeypatch.setenv("MAKISU_TPU_SESSION_TTL", "0")
    time.sleep(0.01)
    for package, (mod, _) in MODS.items():
        (recipe,) = _recipes(tmp_path / f"storage-{package}")
        mgr = mod.manager()
        mgr.reset()
        s, verdict = mgr.acquire(
            str(ctx), "id", restore_spec=(
                str(tmp_path / f"storage-{package}"),
                recipe["portable_identity"]))
        assert verdict == "miss"
        assert mgr.last_restore_failure["reason"] == "stale"
        mgr.release(s)


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_restore_across_packages(tmp_path, monkeypatch, writer, reader):
    """One storage, the writer's recipe, the reader's cold acquire: the
    same portable identity finds the recipe, and the kernel route
    (``isa``) differs, so the restore is refused with ``isa_change``, the
    reference's own reason. With the reader's route set to the
    writer's, the restore works and the image equals the writer's."""
    ctx = _make_ctx(tmp_path)
    digests = _build(tmp_path, ctx, "x/t:1", writer, storage="shared")
    (recipe,) = _recipes(tmp_path / "shared")
    mod = MODS[reader][0]
    assert recipe["isa"] != mod._isa_identity()
    mod.manager().reset()
    assert _build(tmp_path, ctx, "x/t:2", reader,
                  storage="shared") == digests
    mgr = mod.manager()
    assert mgr.last_restore_failure["reason"] == "isa_change"
    assert mgr.snapshot_counts.get("restore", 0) == 0

    # Aligned routes: the writer's snapshot is adopted.
    MODS[writer][0].manager().reset()
    _build(tmp_path, ctx, "x/t:3", writer, storage="shared")
    (recipe,) = _recipes(tmp_path / "shared")
    monkeypatch.setattr(mod, "_isa_identity", lambda: recipe["isa"])
    mgr.reset()
    assert _build(tmp_path, ctx, "x/t:4", reader,
                  storage="shared") == digests
    assert mgr.snapshot_counts.get("restore", 0) == 1
    s = mgr.peek(str(ctx))
    assert s.layer_replay and s.scan_memo


# -- digest integrity under a stale restored stat cache ---------------------


def test_stale_restored_stat_cache_never_replays(tmp_path):
    """Edit a file between checkpoint and restore with its size and
    mtime kept: the restored entries re-hash rather than replay, and the
    rebuild equals a cold oracle build of the edited tree."""
    ctx = _make_ctx(tmp_path)
    d1 = _both(tmp_path, ctx, "snap/stale:1")
    target = ctx / "src" / "m0.py"
    st = target.stat()
    body = target.read_text()
    target.write_text(body.replace("x=1", "x=9", 1))   # same length
    os.utime(target, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert target.stat().st_mtime_ns == st.st_mtime_ns
    for mod, _ in MODS.values():
        mod.manager().reset()
    d2 = _both(tmp_path, ctx, "snap/stale:2")
    assert d2 != d1
    for mod, _ in MODS.values():
        assert mod.manager().snapshot_counts.get("restore", 0) == 1
        mod.manager().reset()
    d3 = _both(tmp_path, ctx, "snap/stale:oracle", storage="oracle")
    assert d2 == d3


# -- eviction labels --------------------------------------------------------


def test_restore_eviction_labels_lru_restore(tmp_path, monkeypatch):
    ctx_a = _make_ctx(tmp_path, "ctxa")
    ctx_b = _make_ctx(tmp_path, "ctxb")
    _both(tmp_path, ctx_a, "snap/a:1")
    _both(tmp_path, ctx_b, "snap/b:1")
    for mod, _ in MODS.values():
        mod.manager().reset()
    monkeypatch.setenv("MAKISU_TPU_SESSION_MAX", "1")
    _both(tmp_path, ctx_a, "snap/a:2")   # restored; 1 resident
    _both(tmp_path, ctx_b, "snap/b:2")   # restored; evicts ctx_a
    for mod, _ in MODS.values():
        mgr = mod.manager()
        assert mgr.snapshot_counts.get("restore", 0) == 2
        assert mgr.invalidations == {"lru_restore": 1}


def test_snapshot_plane_off_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_SESSION_SNAPSHOT", "0")
    ctx = _make_ctx(tmp_path)
    _both(tmp_path, ctx, "off/t:1")
    _both(tmp_path, ctx, "off/t:2")
    for package in MODS:
        assert _recipes(tmp_path / f"storage-{package}") == []


def test_auto_policy_checkpoints_from_the_second_build(tmp_path,
                                                      monkeypatch):
    """The default policy: a one-shot build writes no snapshot, a repeat
    build in the same process does (the session is then resident)."""
    monkeypatch.setenv("MAKISU_TPU_SESSION_SNAPSHOT", "auto")
    ctx = _make_ctx(tmp_path)
    _both(tmp_path, ctx, "auto/t:1")
    counts = [len(_recipes(tmp_path / f"storage-{p}")) for p in MODS]
    _both(tmp_path, ctx, "auto/t:2")
    counts += [len(_recipes(tmp_path / f"storage-{p}")) for p in MODS]
    assert counts == [0, 0, 1, 1]


def test_corrupt_shard_is_refused_not_fatal(tmp_path):
    """A shard whose chunk is gone refuses the restore
    (``chunks_unavailable``) and the build runs cold, in both."""
    ctx = _make_ctx(tmp_path)
    d1 = _both(tmp_path, ctx, "bad/t:1")
    for package, (mod, _) in MODS.items():
        storage = tmp_path / f"storage-{package}"
        (recipe,) = _recipes(storage)
        h = recipe["shards"]["scan"]["chunk"]
        os.unlink(storage / "chunks" / h[:2] / h)
        mod.manager().reset()
    assert _both(tmp_path, ctx, "bad/t:2") == d1
    for mod, _ in MODS.values():
        assert mod.manager().last_restore_failure["reason"] == \
            "chunks_unavailable"
