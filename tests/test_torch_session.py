"""The port's resident build sessions against the JAX package's.

Counterparts of ``tests/test_session.py`` (without the worker's
endpoints, which wait for the port's worker): the walk's dirty-set
primitives, the session manager's lifecycle (identity, TTL, LRU, busy),
the inotify watcher, the stat cache's session surfaces, the MemFS layer
replay, the identities, and end-to-end residency through both CLIs. Each
case drives the same inputs through ``makisu_tpu`` and
``makisu_tpu_torch`` and compares exactly; the watch loop is driven with
its sleep patched, and the ``--watch`` subprocess has a deadline of its
own.
"""

import argparse
import importlib
import io
import json
import os
import signal
import subprocess
import sys
import tarfile
import time

import numpy as np
import pytest

from makisu_tpu import cli as ref_cli
from makisu_tpu.snapshot import memfs as ref_memfs
from makisu_tpu.utils import fileio as ref_fileio
from makisu_tpu.utils import statcache as ref_statcache
from makisu_tpu.worker import session as ref_session
from makisu_tpu_torch import cli
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.utils import fileio, mountinfo, statcache
from makisu_tpu_torch.worker import session

ref_walk = importlib.import_module("makisu_tpu.snapshot.walk")
walk = importlib.import_module("makisu_tpu_torch.snapshot.walk")

PACKAGES = {"ref": (ref_session, ref_walk), "port": (session, walk)}


@pytest.fixture(autouse=True)
def _fresh_sessions(monkeypatch):
    """Empty session registries in both packages, the window-0 racy
    discipline (snapshots certify at once), no mount table and no sync
    wait before a commit (COPY-only builds)."""
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


def rel(paths, root):
    return sorted(os.path.relpath(p, root) for p in paths)


# -- walk delta primitives --------------------------------------------------


def _tree(root, seed=0, n=12):
    rng = np.random.default_rng(seed)
    (root / "a" / "b").mkdir(parents=True)
    for i in range(n):
        d = root / ("a/b" if i % 3 == 0 else "a" if i % 3 == 1 else "")
        (d / f"f{i}").write_bytes(
            rng.integers(0, 256, size=int(rng.integers(1, 4000)),
                         dtype=np.uint8).tobytes())


def test_snapshot_delta_detects_change_add_remove(tmp_path):
    root = tmp_path / "tree"
    _tree(root)
    snaps = {k: w.snapshot_tree(str(root)) for k, (_, w) in PACKAGES.items()}
    assert snaps["port"].sigs == snaps["ref"].sigs
    assert snaps["port"].est_bytes == snaps["ref"].est_bytes
    (root / "a" / "b" / "f0").write_text("changed")
    (root / "a" / "new").write_text("three")
    (root / "f2").unlink()
    deltas = {}
    for k, (_, w) in PACKAGES.items():
        snap2, delta = w.snapshot_delta(snaps[k])
        _, delta2 = w.snapshot_delta(snap2)
        assert not delta2.dirty  # a second delta is clean
        deltas[k] = delta
    for field in ("changed", "added", "removed", "fresh", "dirty",
                  "real_dirty"):
        assert getattr(deltas["port"], field) == getattr(deltas["ref"],
                                                         field)
    assert rel(deltas["port"].changed, root) == ["a", "a/b/f0"]
    assert rel(deltas["port"].added, root) == ["a/new"]
    assert rel(deltas["port"].removed, root) == ["f2"]


def test_snapshot_racy_window_marks_fresh_dirty_once(tmp_path,
                                                     monkeypatch):
    """Files inside the racy window of the capture cannot be certified:
    dirty on the next delta, never a watch rebuild (real_dirty)."""
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE_WINDOW_NS", str(10**12))
    root = tmp_path / "tree"
    root.mkdir()
    (root / "f").write_text("x")
    for _, w in PACKAGES.values():
        snap = w.snapshot_tree(str(root))
        assert str(root / "f") in snap.fresh
        _, delta = w.snapshot_delta(snap)
        assert str(root / "f") in delta.dirty
        assert str(root / "f") not in delta.real_dirty
    assert walk._racy_window_ns() == ref_walk._racy_window_ns() == 10**12


def test_stat_signature_matches_reference(tmp_path):
    f = tmp_path / "f"
    f.write_text("x")
    st = os.lstat(f)
    assert walk.stat_signature(st) == ref_walk.stat_signature(st)


# -- manager lifecycle ------------------------------------------------------


def _both(fn):
    """Run ``fn(session_module)`` on both packages; the results equal."""
    out = {k: fn(mod) for k, (mod, _) in PACKAGES.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def test_acquire_reuse_and_flag_identity_invalidation(tmp_path):
    ctx = tmp_path / "ctx"
    ctx.mkdir()

    def run(mod):
        mgr = mod.manager()
        s1, v1 = mgr.acquire(str(ctx), "identity-a")
        mgr.release(s1)
        s2, v2 = mgr.acquire(str(ctx), "identity-a")
        mgr.release(s2)
        s3, v3 = mgr.acquire(str(ctx), "identity-B")
        mgr.release(s3)
        return [v1, v2, v3, s2 is s1, s3 is s1, dict(mgr.invalidations)]

    assert _both(run) == ["miss", "hit", "miss", True, False,
                          {"flag_identity": 1}]


def test_acquire_busy_bypass(tmp_path):
    ctx = tmp_path / "ctx"
    ctx.mkdir()

    def run(mod):
        mgr = mod.manager()
        s1, _ = mgr.acquire(str(ctx), "id")
        s2, v2 = mgr.acquire(str(ctx), "id")
        mgr.release(s1)
        s3, v3 = mgr.acquire(str(ctx), "id")
        mgr.release(s3)
        return [s2, v2, v3, s3 is s1]

    assert _both(run) == [None, "busy", "hit", True]


def test_ttl_invalidation(tmp_path, monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_SESSION_TTL", "0")
    ctx = tmp_path / "ctx"
    ctx.mkdir()

    def run(mod):
        mgr = mod.manager()
        s1, _ = mgr.acquire(str(ctx), "id")
        mgr.release(s1)
        time.sleep(0.01)
        s2, verdict = mgr.acquire(str(ctx), "id")
        mgr.release(s2)
        return [verdict, s2 is s1, dict(mgr.invalidations)]

    assert _both(run) == ["miss", False, {"ttl": 1}]


def test_lru_cap_evicts_stalest(tmp_path, monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_SESSION_MAX", "1")
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()

    def run(mod):
        mgr = mod.manager()
        s1, _ = mgr.acquire(str(a), "id")
        mgr.release(s1)
        s2, _ = mgr.acquire(str(b), "id")
        mgr.release(s2)
        return [dict(mgr.invalidations), mgr.peek(str(a)),
                mgr.peek(str(b)) is s2]

    assert _both(run) == [{"lru": 1}, None, True]


def test_byte_budget_shrinks_layer_memo_then_evicts(tmp_path, monkeypatch):
    """Over MAKISU_TPU_SESSION_MAX_MB, release first drops the releasing
    session's oldest layer memos, then evicts idle sessions."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    monkeypatch.setenv("MAKISU_TPU_SESSION_MAX_MB", "0.0012")  # 1200 B

    def run(mod):
        mgr = mod.manager()
        s1, _ = mgr.acquire(str(a), "id")
        for d in ("d1", "d2", "d3"):
            s1.replay_store(("", d), [object()])   # 600 B each
        mgr.release(s1)
        kept = sorted(k[1] for k in s1.layer_replay)
        s2, _ = mgr.acquire(str(b), "id")
        s2.replay_store(("", "e1"), [object()])
        for i in range(8):
            s2.scan_store(f"src{i}", i, i, 1, 1)   # 160 B each
        mgr.release(s2)
        return [kept, sorted(s2.layer_replay), mgr.peek(str(a)) is None,
                mgr.peek(str(b)) is s2, dict(mgr.invalidations)]

    assert _both(run) == [["d2", "d3"], [], True, True, {"lru": 1}]


def test_explicit_invalidate(tmp_path):
    ctx = tmp_path / "ctx"
    ctx.mkdir()

    def run(mod):
        mgr = mod.manager()
        s1, _ = mgr.acquire(str(ctx), "id")
        mgr.release(s1)
        return [mgr.invalidate(str(ctx)), mgr.peek(str(ctx)),
                dict(mgr.invalidations)]

    assert _both(run) == [1, None, {"explicit": 1}]


def test_stats_shape(tmp_path):
    ctx = tmp_path / "ctx"
    ctx.mkdir()

    def run(mod):
        mgr = mod.manager()
        s1, _ = mgr.acquire(str(ctx), "id")
        mgr.release(s1)
        stats = mgr.stats()
        row = stats["sessions"][0]
        assert row["watcher"] in ("inotify", "mtime-walk")
        for volatile in ("age_seconds", "idle_seconds", "isa"):
            row.pop(volatile)
        stats["snapshot"]["last_restore_failure"] = {}
        return stats

    stats = _both(run)
    assert stats["count"] == 1 and stats["max_sessions"] >= 1
    assert stats["sessions"][0]["context"] == str(ctx)


def test_bound_manager_scopes_sessions(tmp_path):
    """A bound manager takes the builds of its context (threads copied
    from it included); resetting the token restores the process-wide
    one, as in the reference."""
    ctx = tmp_path / "ctx"
    ctx.mkdir()

    def run(mod):
        mine = mod.SessionManager()
        token = mod.bind_manager(mine)
        try:
            s, _ = mod.manager().acquire(str(ctx), "id")
            mod.manager().release(s)
            bound = mod.manager() is mine
        finally:
            mod.reset_manager(token)
        return [bound, mine.peek(str(ctx)) is s,
                mod.manager().peek(str(ctx))]

    assert _both(run) == [True, True, None]


class _MiniCtx:
    """Just enough BuildContext surface for driving a session directly."""

    def __init__(self, context_dir: str, store_root: str,
                 content_ids=None) -> None:
        import types
        self.context_dir = context_dir
        self.base_blacklist: list = []
        self.image_store = types.SimpleNamespace(root=store_root)
        self.content_ids = content_ids
        self.session = None
        self.dirty_paths: frozenset = frozenset()
        self.dirty_exact = False


@pytest.mark.parametrize("watcher_mode", ["inotify", "mtime-walk"])
def test_mid_build_edit_lands_in_next_dirty_set(tmp_path, monkeypatch,
                                                watcher_mode):
    """An edit racing the build (after its scan passed the file) surfaces
    in the next build's dirty set in both tracker modes, in both
    packages alike."""
    if watcher_mode == "mtime-walk":
        monkeypatch.setenv("MAKISU_TPU_SESSION_MAX_WATCHES", "0")
    else:
        probe = session.InotifyWatcher(str(tmp_path), [])
        healthy = probe.healthy
        probe.close()
        if not healthy:
            pytest.skip("inotify unavailable on this host")
    results = {}
    for name, (mod, _) in PACKAGES.items():
        ctx_dir = tmp_path / name / "ctx"
        ctx_dir.mkdir(parents=True)
        victim = ctx_dir / "f.txt"
        victim.write_text("v1")
        mgr = mod.manager()
        s, _ = mgr.acquire(str(ctx_dir), "id")
        ctx = _MiniCtx(str(ctx_dir), str(tmp_path / name / "store"))
        mode1 = s.begin_build(ctx)
        kind = s.stats()["watcher"]
        victim.write_text("v2-mid-build")
        s.finish_build(ctx, ok=True)
        mgr.release(s)
        s2, verdict = mgr.acquire(str(ctx_dir), "id")
        mode2 = s2.begin_build(ctx)
        results[name] = [mode1, kind, verdict, mode2, ctx.dirty_exact,
                         rel(ctx.dirty_paths, ctx_dir)]
        s2.finish_build(ctx, ok=True)
        mgr.release(s2)
    assert results["port"] == results["ref"]
    assert results["port"][1] == watcher_mode
    # Exact with the edit in it (inotify), or inexact with the whole
    # context flagged (a one-shot first build arms no walk baseline).
    assert results["port"][4:] == ([True, ["f.txt"]]
                                   if watcher_mode == "inotify"
                                   else [False, ["."]])


def _cache_for(mod, tmp_path):
    """A stat cache of ``mod``'s package."""
    sc = statcache if mod is session else ref_statcache
    return sc.ContentIDCache(str(tmp_path / f"{mod.__name__}.json"))


def test_watch_knowledge_loss_flags_context_dirty(tmp_path, monkeypatch):
    """A dead tracker (no watcher, no baseline) flags the whole context
    dirty once and takes a baseline; the next poll sees the edit."""
    monkeypatch.setenv("MAKISU_TPU_SESSION_MAX_WATCHES", "0")

    def run(mod):
        ctx_dir = tmp_path / mod.__name__.split(".")[0] / "ctx"
        ctx_dir.mkdir(parents=True)
        (ctx_dir / "f").write_text("x")
        mgr = mod.manager()
        s, _ = mgr.acquire(str(ctx_dir), "id")
        s._walk_blacklist = []
        s._resident_hint = True  # a watch loop's session
        first = rel(s.poll_changes(), ctx_dir)
        seeded = s.snapshot is not None
        (ctx_dir / "f").write_text("y")
        second = rel(s.poll_changes(), ctx_dir)
        mgr.release(s)
        return [first, seeded, second, s.exact]

    assert _both(run) == [["."], True, ["f"], False]


def test_failed_build_clears_memo_and_dirty_knowledge(tmp_path):
    """finish_build(ok=False): the scan memo goes, the dirty set is
    inexact and the baseline dropped, so the next build scans all."""
    ctx_dir = tmp_path / "ctx"
    ctx_dir.mkdir()

    def run(mod):
        mgr = mod.manager()
        s, _ = mgr.acquire(str(ctx_dir), "id")
        ctx = _MiniCtx(str(ctx_dir), str(tmp_path / "store"),
                       _cache_for(mod, tmp_path))
        s.begin_build(ctx, resident_process=True)
        s.finish_build(ctx, ok=True)
        s.scan_store("src", 1, 2, 3, 4)
        exact_after_ok = s.exact
        s.begin_build(ctx)
        s.finish_build(ctx, ok=False)
        mgr.release(s)
        state = [exact_after_ok, s.exact, s.snapshot, dict(s.scan_memo),
                 set(s.pending_dirty), ctx.session]
        mgr.reset()
        return state

    assert _both(run) == [True, False, None, {}, set(), None]


# -- inotify watcher --------------------------------------------------------


def _watchers_or_skip(root: str):
    out = {k: mod.InotifyWatcher(root, []) for k, (mod, _) in
           PACKAGES.items()}
    if not all(w.healthy for w in out.values()):
        for w in out.values():
            w.close()
        pytest.skip("inotify unavailable on this host")
    return out


def _collect_until(watchers, want, deadline_s=2.0):
    got = {k: set() for k in watchers}
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        for k, w in watchers.items():
            got[k] |= w.collect() or set()
        if all(want <= g for g in got.values()):
            break
        time.sleep(0.01)
    return got


def test_inotify_collects_file_edits(tmp_path):
    root = tmp_path / "tree"
    (root / "sub").mkdir(parents=True)
    (root / "sub" / "f").write_text("x")
    watchers = _watchers_or_skip(str(root))
    try:
        (root / "sub" / "f").write_text("y")
        got = _collect_until(watchers, {str(root / "sub" / "f")})
        assert got["port"] == got["ref"] == {str(root / "sub" / "f")}
    finally:
        for w in watchers.values():
            w.close()


def test_inotify_new_dir_marks_dirty_and_resyncs(tmp_path):
    root = tmp_path / "tree"
    root.mkdir()
    watchers = _watchers_or_skip(str(root))
    try:
        (root / "newdir").mkdir()
        got = _collect_until(watchers, {str(root / "newdir")})
        assert got["port"] == got["ref"] == {str(root / "newdir")}
        for w in watchers.values():
            w.resync()
            assert w.healthy
        # After the resync, events inside the new dir are seen.
        (root / "newdir" / "f").write_text("x")
        want = {str(root / "newdir" / "f")}
        got = _collect_until(watchers, want)
        assert want <= got["port"] and got["port"] == got["ref"]
    finally:
        for w in watchers.values():
            w.close()


def test_inotify_watch_limit_falls_back_to_walk(tmp_path, monkeypatch):
    """More directories than MAKISU_TPU_SESSION_MAX_WATCHES: the watcher
    is unhealthy, and a session's build runs on the mtime walk instead of
    failing."""
    root = tmp_path / "tree"
    for i in range(5):
        (root / f"d{i}").mkdir(parents=True)
    monkeypatch.setenv("MAKISU_TPU_SESSION_MAX_WATCHES", "3")
    kinds = []
    for mod, _ in PACKAGES.values():
        w = mod.InotifyWatcher(str(root), [])
        assert not w.healthy
        w.close()
        s = mod.BuildSession(str(root), "id")
        ctx = _MiniCtx(str(root), str(tmp_path / "store"),
                       _cache_for(mod, tmp_path))
        s.begin_build(ctx, resident_process=True)
        kinds.append(s.stats()["watcher"])
        s.finish_build(ctx, ok=True)
        assert s.exact  # the walk baseline certifies the next build
        s.close()
    assert kinds == ["mtime-walk", "mtime-walk"]


# -- BuildContext.source_unchanged ------------------------------------------


@pytest.mark.parametrize("dirty,exact,want", [
    ((), True, True),
    (("/c/src/a.txt",), True, False),      # below the source
    (("/c/src",), True, False),            # the source itself
    (("/c",), True, False),                # an ancestor (a rename)
    (("/c/src2/f", "/c/srcx"), True, True),  # a sibling with its prefix
    (("/c/other/f",), True, True),
    ((), False, False),                    # inexact: nothing is proven
])
def test_source_unchanged_matches_reference(dirty, exact, want):
    from makisu_tpu.context import BuildContext as RefBuildContext
    from makisu_tpu_torch.context import BuildContext
    got = []
    for cls in (BuildContext, RefBuildContext):
        ctx = cls.__new__(cls)
        ctx.dirty_paths = frozenset(dirty)
        ctx.dirty_exact = exact
        got.append([ctx.source_unchanged("/c/src"),
                    ctx.source_unchanged("/c/src/")])
    assert got[0] == got[1] == [want, want]


# -- the stat cache's session surfaces, atomic writes ------------------------


def test_statcache_save_atomic_and_begin_build(tmp_path):
    recs = []
    (tmp_path / "f").write_text("data")
    for mod in (statcache, ref_statcache):
        path = tmp_path / f"{mod.__name__}.json"
        cache = mod.ContentIDCache(str(path), namespace="ns")
        cache.put("f", os.lstat(tmp_path / "f"), 123)
        cache.save()
        rec = json.loads(path.read_text())
        assert cache._touched
        cache.begin_build()
        assert not cache._touched
        recs.append({k: v[:2] for k, v in rec["entries"].items()})
        assert rec["version"] == 2
    assert recs[0] == recs[1] and "ns\x00f" in recs[0]
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []


def test_statcache_snapshot_surfaces_match_reference(tmp_path):
    """namespace_items, drain_mutations and merge_entries act alike."""
    (tmp_path / "a").write_text("a")
    (tmp_path / "b").write_text("bb")
    out = []
    for mod in (statcache, ref_statcache):
        cache = mod.ContentIDCache(str(tmp_path / f"{mod.__name__}.json"),
                                   namespace="ctx")
        other = mod.ContentIDCache(cache.path, namespace="other")
        cache.put("a", os.lstat(tmp_path / "a"), 1)
        cache.put("b", os.lstat(tmp_path / "b"), 2)
        drained = cache.drain_mutations()
        again = cache.drain_mutations()
        items = {k: v[:2] for k, v in cache.namespace_items().items()}
        adopted = other.merge_entries({
            "a": [[1, 2, 3, 4, 5], 9, 0], "bad": "x", "b": [[1], 8, 0]})
        readopted = other.merge_entries({"a": [[0], 0, 0]})
        out.append([drained, again, items, adopted, readopted,
                    other.namespace_items()])
    assert out[0] == out[1]
    assert out[0][0] == {"a", "b"} and out[0][3] == 2 and out[0][4] == 0


def test_deferred_saves_coalesce_and_flush_lands_the_last(tmp_path,
                                                          monkeypatch):
    """defer_save: one saver thread at a time; a save that finds one in
    flight only marks the cache dirty (the reference's coalescing), so
    without a later save its news stays in memory. ``flush`` (the port's
    watch loop calls it on Ctrl-C) waits for the saver and writes it."""
    import threading
    gate = threading.Event()
    writes = []
    real_write = statcache.ContentIDCache._write

    def slow_write(self, entries):
        gate.wait(5)
        writes.append(sorted(entries))
        real_write(self, entries)

    monkeypatch.setattr(statcache.ContentIDCache, "_write", slow_write)
    path = tmp_path / "cache.json"
    cache = statcache.ContentIDCache(str(path), namespace="ns")
    cache.defer_save = True
    (tmp_path / "f").write_text("x")
    cache.put("f", os.lstat(tmp_path / "f"), 1)
    cache.save()                      # starts the saver, which waits
    cache.put("g", os.lstat(tmp_path / "f"), 2)
    cache.save()                      # coalesced: the saver is busy
    assert cache._dirty and not path.exists()
    gate.set()
    cache.flush()
    assert writes == [["ns\x00f"], ["ns\x00f", "ns\x00g"]]
    assert sorted(json.loads(path.read_text())["entries"]) == \
        ["ns\x00f", "ns\x00g"]
    assert cache.defer_save and not cache._dirty


@pytest.mark.parametrize("writer", ["json", "bytes"])
def test_atomic_writes_clean_tmp_on_failure(tmp_path, writer):
    target = tmp_path / "out"
    circular: list = []
    circular.append(circular)
    with pytest.raises(ValueError):
        fileio.write_json_atomic(str(target), circular)
    with pytest.raises(ValueError):
        ref_fileio.write_json_atomic(str(target), circular)
    if writer == "bytes":
        with pytest.raises(TypeError):
            fileio.write_bytes_atomic(str(target), "not bytes")
        fileio.write_bytes_atomic(str(target), b"\x00payload")
        ref_fileio.write_bytes_atomic(str(tmp_path / "ref"), b"\x00payload")
        assert target.read_bytes() == (tmp_path / "ref").read_bytes()
    else:
        doc = {"b": [1, 2.5, "é"], "a": None}
        fileio.write_json_atomic(str(target), doc)
        ref_fileio.write_json_atomic(str(tmp_path / "ref"), doc)
        assert target.read_bytes() == (tmp_path / "ref").read_bytes()
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []


# -- MemFS layer replay -----------------------------------------------------


def _layer_tar(files: dict) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        dirs = sorted({os.path.dirname(n) for n in files if "/" in n})
        for d in dirs:
            info = tarfile.TarInfo(d)
            info.type = tarfile.DIRTYPE
            info.mode = 0o755
            tf.addfile(info)
        for name, body in files.items():
            if body is None:
                head, base = os.path.split(name)
                info = tarfile.TarInfo(os.path.join(head, ".wh." + base))
                tf.addfile(info)
                continue
            info = tarfile.TarInfo(name)
            info.size = len(body)
            info.mode = 0o644
            info.mtime = 1_700_000_000
            tf.addfile(info, io.BytesIO(body))
    return buf.getvalue()


def _tree_of(fs):
    out = {}

    def visit(node, path):
        h = node.hdr
        out[path] = (h.name, h.type, h.size, h.mode, h.mtime, node.src)
        for name, child in node.children.items():
            visit(child, path + "/" + name)

    visit(fs.tree, "")
    return out


def test_replay_layer_tree_equals_inflated(tmp_path):
    """A recorded layer replayed on a fresh tree gives the tree its
    inflation gave, with the same applied chain, in both packages."""
    root = tmp_path / "root"
    root.mkdir()
    layers = [
        ("a" * 64, _layer_tar({"app/x.txt": b"x" * 100,
                               "app/y.txt": b"y" * 7})),
        ("b" * 64, _layer_tar({"app/y.txt": b"yy" * 9, "app/x.txt": None,
                               "etc/z": b"z"})),
    ]
    results = {}
    for name, mod in (("port", memfs), ("ref", ref_memfs)):
        inflated = mod.MemFS(str(root), [])
        records = []
        for digest, blob in layers:
            rec = []
            with tarfile.open(fileobj=io.BytesIO(blob), mode="r|") as tf:
                inflated.update_from_tar(tf, untar=False, record=rec,
                                         chain_key=digest)
            records.append(rec)
        replayed = mod.MemFS(str(root), [])
        for (digest, _), rec in zip(layers, records):
            replayed.replay_layer(rec, chain_key=digest)
        assert _tree_of(replayed) == _tree_of(inflated)
        assert replayed.applied_chain == inflated.applied_chain
        assert not replayed.chain_tainted and not inflated.chain_tainted
        untainted = mod.MemFS(str(root), [])
        with tarfile.open(fileobj=io.BytesIO(layers[0][1]),
                          mode="r|") as tf:
            untainted.update_from_tar(tf, untar=False)
        results[name] = [_tree_of(inflated), inflated.applied_chain,
                         [len(r) for r in records], untainted.chain_tainted]
    assert results["port"] == results["ref"]
    assert results["port"][3] is True  # a merge without a key taints


# -- identities -------------------------------------------------------------


def _args(parser, argv):
    ns = parser.parse_args(argv)
    assert isinstance(ns, argparse.Namespace)
    return ns


def test_identities_hash_the_reference_dict(tmp_path):
    """Same flags, same digests; the port's ``--hasher gpu`` hashes the
    reference's dict with the port's value in it."""
    argv = ["build", str(tmp_path / "ctx"), "-t", "a/b:1", "--root",
            str(tmp_path / "root"), "--build-arg", "B=2", "--build-arg",
            "A=1", "--blacklist", "/x", "--target", "t"]
    port_args = _args(cli.make_parser(), argv + ["--hasher", "cpu"])
    ref_args = _args(ref_cli.make_parser(), argv + ["--hasher", "cpu"])
    for fn, extra in (("identity_from_build_args", (str(tmp_path / "s"),)),
                      ("portable_identity_from_build_args", ())):
        got = getattr(session, fn)(port_args, *extra, "gzip-6")
        assert got == getattr(ref_session, fn)(ref_args, *extra, "gzip-6")
    gpu_args = _args(cli.make_parser(), argv)
    assert gpu_args.hasher == "gpu"
    ident = ref_session._identity_dict(ref_args, "gzip-6")
    ident["hasher"] = "gpu"
    assert session.portable_identity_from_build_args(gpu_args, "gzip-6") \
        == ref_session._digest_identity(ident)


def test_isa_identity_never_loads_a_library(monkeypatch):
    """The kernel route is read, never resolved: no build or load of a
    library; the CPU device leaves it unresolved."""
    from makisu_tpu_torch.ops import _build, backend

    def boom(*a, **k):
        raise AssertionError("a session forced a library build or load")

    monkeypatch.setattr(_build, "library", boom)
    monkeypatch.setattr(_build, "build_all", boom)
    monkeypatch.setattr(backend, "_route", None)
    backend.resolve_device("cpu")
    assert session._isa_identity() == "unresolved"
    monkeypatch.setattr(backend.torch.cuda, "is_available", lambda: True)
    backend.resolve_device(None)
    route = session._isa_identity()
    assert route == ",".join(_build.library_path(n).stem
                             for n in _build.SOURCES)
    backend.resolve_device("cpu")
    assert session._isa_identity() == route  # sticky


# -- end-to-end residency through the CLI -----------------------------------


def _make_ctx(tmp_path):
    ctx = tmp_path / "ctx"
    (ctx / "src").mkdir(parents=True)
    (ctx / "Dockerfile").write_text(
        "FROM scratch\nCOPY src/ /src/\nCOPY top.txt /top.txt\n")
    for i in range(4):
        (ctx / "src" / f"m{i}.py").write_text(f"# {i}\n" + "x=1\n" * 50)
    (ctx / "top.txt").write_text("top")
    (tmp_path / "root").mkdir()
    return ctx


def _layers(storage, tag):
    repo, t = tag.split(":")
    with open(storage / "manifests" / repo / f"{t}.json") as f:
        return [l["digest"] for l in json.load(f)["layers"]]


def build_pair(tmp_path, ctx, tag, modes, storage="storage", extra=()):
    """One build per package (the port through ``cli.main(...,
    device="cpu")``); their layer digests equal. Returns them."""
    out = []
    for name, main in (("port", lambda a: cli.main(a, device="cpu")),
                       ("ref", ref_cli.main)):
        st = tmp_path / f"{storage}-{name}"
        code = main(["--log-level", "error", "build", str(ctx), "-t", tag,
                     "--hasher", "cpu", "--storage", str(st), "--root",
                     str(tmp_path / "root"), *extra])
        assert code == 0
        out.append(_layers(st, tag))
    assert out[0] == out[1]
    return out[0]


@pytest.fixture
def modes(monkeypatch):
    """The warm mode of each build, by package."""
    seen = {"port": [], "ref": []}
    monkeypatch.setattr(session, "set_warm_mode", seen["port"].append)
    monkeypatch.setattr(ref_session, "set_warm_mode", seen["ref"].append)
    return seen


def _state(mod, ctx):
    s = mod.manager().peek(str(ctx))
    return {"builds": s.builds, "hits": s.hits, "exact": s.exact,
            "scan_memo": dict(s.scan_memo),
            "layer_keys": sorted(s.layer_replay)}


def test_cli_builds_reuse_session_and_digests_match(tmp_path, modes):
    ctx = _make_ctx(tmp_path)
    d1 = build_pair(tmp_path, ctx, "s/t:1", modes)
    d2 = build_pair(tmp_path, ctx, "s/t:2", modes)
    assert d1 == d2
    assert _state(session, ctx) == _state(ref_session, ctx)
    assert _state(session, ctx)["layer_keys"]  # applied layers memoized
    d3 = build_pair(tmp_path, ctx, "s/t:3", modes)
    assert d3 == d1
    state = _state(session, ctx)
    assert state == _state(ref_session, ctx)
    assert state["builds"] == 3 and state["hits"] >= 2
    assert len(state["scan_memo"]) == 2
    assert modes["port"] == modes["ref"] == ["fresh", "resident",
                                             "resident"]


def test_cli_session_disabled_env(tmp_path, monkeypatch, modes):
    monkeypatch.setenv("MAKISU_TPU_SESSION", "0")
    ctx = _make_ctx(tmp_path)
    build_pair(tmp_path, ctx, "s/off:1", modes)
    build_pair(tmp_path, ctx, "s/off:2", modes)
    assert session.manager().peek(str(ctx)) is None
    assert ref_session.manager().peek(str(ctx)) is None
    assert modes["port"] == modes["ref"] == ["off", "off"]


def test_resident_build_replays_layers_and_reads_no_context_file(
        tmp_path, modes, monkeypatch):
    """The third build of an untouched context replays every cached
    layer from the memo and every COPY source from the scan memo: no
    blob opened and no context file read, in either package."""
    import builtins

    ctx = _make_ctx(tmp_path)
    build_pair(tmp_path, ctx, "r/t:1", modes)
    build_pair(tmp_path, ctx, "r/t:2", modes)
    opened = []
    real_open = builtins.open

    def counting_open(path, mode="r", *a, **k):
        p = str(path)
        reading = not any(c in mode for c in "wax+")
        if reading and (p.startswith(str(ctx)) or "/layers/" in p):
            opened.append(p)
        return real_open(path, mode, *a, **k)

    monkeypatch.setattr(builtins, "open", counting_open)
    logs = tmp_path / "port.log"
    assert cli.main(["--log-output", str(logs), "build", str(ctx), "-t",
                     "r/t:3", "--hasher", "cpu", "--storage",
                     str(tmp_path / "storage-port"), "--root",
                     str(tmp_path / "root")], device="cpu") == 0
    lines = [json.loads(line) for line in logs.read_text().splitlines()]
    msgs = [rec["msg"] for rec in lines]
    replays = [m for m in msgs if m.startswith("replaying resident layer")]
    assert len(replays) == 2
    assert not [m for m in msgs if m.startswith("applying cached layer")]
    assert [p for p in opened if not p.endswith(
        ("Dockerfile", ".dockerignore"))] == []
    tallies = [rec for rec in lines if rec["msg"].startswith("stat cache")]
    assert [t["memo_sources"] for t in tallies] == [1, 1]
    assert modes["port"][-1] == "resident"


# -- build --watch ----------------------------------------------------------


def test_watch_flag_is_accepted():
    args = cli.make_parser().parse_args(
        ["build", "ctx", "-t", "a:b", "--watch", "--watch-interval", "0.2"])
    assert args.watch and args.watch_interval == 0.2
    assert not cli.make_parser().parse_args(
        ["build", "ctx", "-t", "a:b"]).watch


def _drive_watch(tmp_path, ctx, monkeypatch, edits, interval="0.1"):
    """Run the port's ``build --watch`` in this process; each sleep of the
    loop makes the next edit, and the sleep after the last one stops the
    loop with Ctrl-C. Returns the exit code and the log records."""
    pending = list(edits)
    deadline = time.time() + 60
    real_sleep = time.sleep

    def fake_sleep(seconds):
        if sys._getframe(1).f_globals.get("__name__") != cli.__name__:
            return real_sleep(seconds)  # another thread's sleep
        assert time.time() < deadline, "watch loop did not rebuild"
        if not pending:
            raise KeyboardInterrupt
        pending.pop(0)()

    monkeypatch.setattr(time, "sleep", fake_sleep)
    logs = tmp_path / "watch.log"
    code = cli.main(["--log-output", str(logs), "build", str(ctx), "-t",
                     "w/t:1", "--hasher", "cpu", "--storage",
                     str(tmp_path / "storage-watch"), "--root",
                     str(tmp_path / "root"), "--watch", "--watch-interval",
                     interval], device="cpu")
    return code, [json.loads(line)
                  for line in logs.read_text().splitlines()]


def test_watch_rebuilds_on_edit_and_survives_a_failing_rebuild(
        tmp_path, monkeypatch):
    ctx = _make_ctx(tmp_path)
    dockerfile = (ctx / "Dockerfile").read_text()

    def edit():
        (ctx / "src" / "m1.py").write_text("# edited\n")

    def break_it():
        (ctx / "Dockerfile").write_text("FROM scratch\nCOPY nope/ /x/\n")

    def repair():
        (ctx / "Dockerfile").write_text(dockerfile)

    code, recs = _drive_watch(tmp_path, ctx, monkeypatch,
                              [edit, lambda: None, break_it, repair])
    msgs = [r["msg"] for r in recs]
    rebuilds = [m for m in msgs if m.startswith("watch: rebuild #")]
    assert rebuilds == ["watch: rebuild #2 exited 0",
                        "watch: rebuild #3 exited 1",
                        "watch: rebuild #4 exited 0"]
    assert code == 0
    # The watch loop's last line, then the command's telemetry epilogue
    # (the reference's order: the "build telemetry" line ends a build
    # command).
    assert msgs[-2:] == ["watch: stopped after 4 builds", "build telemetry"]
    modes = [r["mode"] for r in recs if r.get("mode")]
    assert modes[0] == "rescan" and modes[1] == "resident"
    # The watch build's image equals a session-less build of the tree.
    monkeypatch.setenv("MAKISU_TPU_SESSION", "0")
    build_pair(tmp_path, ctx, "w/t:1", None, storage="oracle")
    assert _layers(tmp_path / "storage-watch", "w/t:1") == \
        _layers(tmp_path / "oracle-port", "w/t:1")


def test_watch_exits_with_the_last_builds_code(tmp_path, monkeypatch):
    ctx = _make_ctx(tmp_path)

    def break_it():
        (ctx / "Dockerfile").write_text("FROM scratch\nCOPY nope/ /x/\n")

    code, recs = _drive_watch(tmp_path, ctx, monkeypatch, [break_it])
    assert code == 1
    assert "watch: rebuild #2 exited 1" in [r["msg"] for r in recs]


def test_watch_without_sessions_polls_the_tree(tmp_path, monkeypatch):
    """MAKISU_TPU_SESSION=0: the standalone mtime walk drives rebuilds
    (the first tick takes its baseline)."""
    monkeypatch.setenv("MAKISU_TPU_SESSION", "0")
    ctx = _make_ctx(tmp_path)

    def edit():
        (ctx / "top.txt").write_text("top, edited")

    code, recs = _drive_watch(tmp_path, ctx, monkeypatch,
                              [lambda: None, edit])
    msgs = [r["msg"] for r in recs]
    assert code == 0
    assert "watch: rebuild #2 exited 0" in msgs
    assert not any(m.startswith("build session ") and "mode=" in m
                   for m in msgs)


def test_watch_subprocess_rebuilds_and_exits_on_sigint(tmp_path):
    """``python -m makisu_tpu_torch.cli build --watch`` as a process: the
    initial build, an edit, "watch: rebuild #2 exited 0", then SIGINT
    and rc 0. Every wait has a deadline."""
    ctx = _make_ctx(tmp_path)
    logs = tmp_path / "watch.log"
    env = dict(os.environ, MAKISU_TPU_STAT_CACHE_WINDOW_NS="0",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(cli.__file__)),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "makisu_tpu_torch.cli", "--log-output",
         str(logs), "build", str(ctx), "-t", "w/p:1", "--hasher", "cpu",
         "--storage", str(tmp_path / "storage"), "--root",
         str(tmp_path / "root"), "--watch", "--watch-interval", "0.1"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

    def wait_for(text, seconds=60):
        deadline = time.time() + seconds
        while time.time() < deadline:
            if logs.exists() and text in logs.read_text():
                return
            assert proc.poll() is None, proc.stderr.read().decode()
            time.sleep(0.05)
        proc.kill()
        pytest.fail(f"no {text!r} within {seconds} s")

    try:
        wait_for("watch: initial build exited 0")
        (ctx / "src" / "m2.py").write_text("# edited\n")
        wait_for("watch: rebuild #2 exited 0")
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "watch: stopped after 2 builds" in logs.read_text()
