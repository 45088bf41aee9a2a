"""The port's stat-keyed content-ID cache against the JAX package's.

Counterparts of ``tests/test_statcache.py`` on ``makisu_tpu_torch``, and
the cross-package cases: a ``content_id_cache.json`` written by either
package serves the other with no context file read by the cache-ID walk
and with equal cache IDs. The skipped-reads cases count only the opens
made by the walk (``steps/add_copy.py``): a COPY layer's commit reads
the files too, through the layer writer's read-ahead, and that is not a
checksum read.
"""

import builtins
import json
import os
import sys
import time
import types
import zlib

import pytest

from makisu_tpu.builder import BuildPlan as RefBuildPlan
from makisu_tpu.cache import NoopCacheManager as RefNoopCacheManager
from makisu_tpu.context import BuildContext as RefBuildContext
from makisu_tpu.docker.image import ImageName as RefImageName
from makisu_tpu.dockerfile import parse_file as ref_parse_file
from makisu_tpu.storage import ImageStore as RefImageStore
from makisu_tpu.utils import statcache as ref_statcache
from makisu_tpu_torch.builder import BuildPlan
from makisu_tpu_torch.cache import NoopCacheManager
from makisu_tpu_torch.context import BuildContext
from makisu_tpu_torch.docker.image import ImageName
from makisu_tpu_torch.dockerfile import parse_file
from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.steps import add_copy
from makisu_tpu_torch.storage import ImageStore
from makisu_tpu_torch.utils import mountinfo, statcache
from makisu_tpu_torch.utils.statcache import ContentIDCache

DOCKERFILE = "FROM scratch\nCOPY . /app/\n"
WALKS = {"port": add_copy.__name__, "ref": "makisu_tpu.steps.add_copy"}


@pytest.fixture(autouse=True)
def _no_mounts_no_wait(monkeypatch):
    mountinfo.set_mountpoints_for_testing(set())
    monkeypatch.setattr(memfs.MemFS, "_sync", lambda self: None)
    yield
    mountinfo.set_mountpoints_for_testing(None)


def _build(tmp_path, tag, store_name="store", package="port"):
    """One ``FROM scratch / COPY . /app/`` build of ``tmp_path/ctx`` with
    a forced commit; returns (manifest, the COPY steps' cache IDs)."""
    ctx_dir = tmp_path / "ctx"
    root = tmp_path / f"root-{package}-{tag}"
    root.mkdir()
    if package == "port":
        store = ImageStore(str(tmp_path / store_name))
        ctx = BuildContext(str(root), str(ctx_dir), store)
        plan = BuildPlan(ctx, ImageName("", "t/statcache", tag), [],
                         NoopCacheManager(), parse_file(DOCKERFILE),
                         allow_modify_fs=False, force_commit=True)
    else:
        store = RefImageStore(str(tmp_path / store_name))
        ctx = RefBuildContext(str(root), str(ctx_dir), store, sync_wait=0.0)
        plan = RefBuildPlan(ctx, RefImageName("", "t/statcache", tag), [],
                            RefNoopCacheManager(), ref_parse_file(DOCKERFILE),
                            allow_modify_fs=False, force_commit=True)
    manifest = plan.execute()
    return manifest, [s.nodes[-1].step.cache_id for s in plan.stages]


@pytest.fixture
def walk_reads(monkeypatch):
    """Context files opened by a package's cache-ID walk (callers in its
    ``steps/add_copy.py``), by package."""
    reads = {"port": [], "ref": []}
    real_open = builtins.open

    def counting_open(path, *a, **k):
        caller = sys._getframe(1).f_globals.get("__name__")
        for package, module in WALKS.items():
            if caller == module:
                reads[package].append(str(path))
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", counting_open)
    return reads


def _fake_stat(size=3, ino=7, dev=11, age_s=10.0):
    now = time.time_ns()
    t = now - int(age_s * 1e9)
    return types.SimpleNamespace(st_size=size, st_mtime_ns=t,
                                 st_ctime_ns=t, st_ino=ino, st_dev=dev)


def _context(tmp_path, n=20, size=3000):
    ctx_dir = tmp_path / "ctx"
    ctx_dir.mkdir()
    for i in range(n):
        (ctx_dir / f"f{i}.bin").write_bytes(os.urandom(size))
    return ctx_dir


def test_warm_build_skips_unchanged_file_reads(tmp_path, monkeypatch,
                                               walk_reads):
    # Window 0: the files were just written; the racily-clean guard is
    # tested on its own below.
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE_WINDOW_NS", "0")
    _context(tmp_path)
    m1, ids1 = _build(tmp_path, "a")
    assert (tmp_path / "store" / "content_id_cache.json").exists()
    assert len([p for p in walk_reads["port"] if p.endswith(".bin")]) == 20
    walk_reads["port"].clear()
    m2, ids2 = _build(tmp_path, "b")
    assert ids1 == ids2  # identity unchanged
    assert [str(layer.digest) for layer in m1.layers] == \
        [str(layer.digest) for layer in m2.layers]
    assert walk_reads["port"] == []


def test_content_change_misses_even_with_restored_mtime(tmp_path,
                                                        monkeypatch):
    # Window 0 isolates the ctime mechanism from the racy guard.
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE_WINDOW_NS", "0")
    ctx_dir = tmp_path / "ctx"
    ctx_dir.mkdir()
    victim = ctx_dir / "v.bin"
    victim.write_bytes(b"A" * 4096)
    _, ids1 = _build(tmp_path, "a")
    st = victim.stat()
    victim.write_bytes(b"B" * 4096)  # same size
    os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns))  # spoof mtime
    _, ids2 = _build(tmp_path, "b")
    # ctime moved (utime cannot restore it): the cache missed, the file
    # re-hashed, and the COPY step's cache ID moved.
    assert ids1 != ids2


def test_racily_clean_entries_are_not_trusted(tmp_path):
    c = ContentIDCache(str(tmp_path / "c.json"))
    st = _fake_stat(age_s=0.0)  # written "now", hashed "now"
    c.put("f", st, 123)
    assert c.get("f", st) is None  # inside the racy window
    assert c.lookup("f", st) == (None, "racy")
    old = _fake_stat(age_s=10.0)  # timestamps 10 s before the hash
    c.put("g", old, 456)
    assert c.get("g", old) == 456  # safely clean


def test_disabled_switch_preserves_identity(tmp_path, monkeypatch):
    _context(tmp_path, n=1, size=5000)
    _, ids_on = _build(tmp_path, "a")
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE", "0")
    _, ids_off = _build(tmp_path, "b", store_name="store2")
    assert ids_on == ids_off


def test_cache_survives_corrupt_file(tmp_path):
    cache_path = tmp_path / "cache.json"
    cache_path.write_text("{not json")
    c = ContentIDCache(str(cache_path))
    st = _fake_stat()
    assert c.get("a", st) is None
    c.put("a", st, 123)
    c.save()
    assert ContentIDCache(str(cache_path)).get("a", st) == 123


def test_stat_key_covers_inode_and_device(tmp_path):
    c = ContentIDCache(str(tmp_path / "c.json"))
    st = _fake_stat(ino=7, dev=11)
    c.put("f", st, zlib.crc32(b"abc"))
    assert c.get("f", st) == zlib.crc32(b"abc")
    assert c.get("f", _fake_stat(ino=8, dev=11)) is None
    assert c.get("f", _fake_stat(ino=7, dev=12)) is None


def test_namespace_scopes_contexts(tmp_path):
    path = str(tmp_path / "c.json")
    a = ContentIDCache(path, namespace="/ctx/a")
    st = _fake_stat()
    a.put("data.bin", st, 111)
    a.save()
    assert ContentIDCache(path, namespace="/ctx/b").get("data.bin", st) \
        is None
    assert ContentIDCache(path, namespace="/ctx/a").get("data.bin", st) \
        == 111


# -- the port against the reference ------------------------------------------

def test_file_format_and_constants_match_reference(tmp_path):
    assert statcache.VERSION == ref_statcache.VERSION == 2
    assert statcache.RACY_WINDOW_NS == ref_statcache.RACY_WINDOW_NS
    st = _fake_stat(size=9, ino=5, dev=3)
    for writer, reader in ((ContentIDCache, ref_statcache.ContentIDCache),
                           (ref_statcache.ContentIDCache, ContentIDCache)):
        path = str(tmp_path / f"{writer.__module__}.json")
        w = writer(path, namespace="/ctx")
        w.put("a/b.js", st, 0xDEADBEEF)
        w.save()
        assert reader(path, namespace="/ctx").lookup("a/b.js", st) == \
            (0xDEADBEEF, "hit")
        with open(path) as f:
            rec = json.load(f)
        assert rec["version"] == 2 and list(rec["entries"]) == \
            ["/ctx\x00a/b.js"]


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_either_packages_cache_serves_the_other(tmp_path, monkeypatch,
                                                walk_reads, first, second):
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE_WINDOW_NS", "0")
    _context(tmp_path, n=12)
    (tmp_path / "ctx" / "sub").mkdir()
    (tmp_path / "ctx" / "sub" / "x.txt").write_text("x\n")
    os.symlink("f0.bin", tmp_path / "ctx" / "link.bin")
    _, ids1 = _build(tmp_path, "a", package=first)
    assert len(walk_reads[first]) == 13
    _, ids2 = _build(tmp_path, "b", package=second)
    assert ids1 == ids2
    assert walk_reads[second] == []


def test_stat_cache_off_rereads_every_file(tmp_path, monkeypatch,
                                           walk_reads):
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE_WINDOW_NS", "0")
    _context(tmp_path, n=8)
    _, ids1 = _build(tmp_path, "a")
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE", "0")
    walk_reads["port"].clear()
    _, ids2 = _build(tmp_path, "b")
    assert len(walk_reads["port"]) == 8
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE", "1")
    walk_reads["port"].clear()
    _, ids3 = _build(tmp_path, "c")
    assert walk_reads["port"] == []
    assert ids1 == ids2 == ids3


def test_ctime_spoofed_edit_misses_with_its_reason(tmp_path, monkeypatch):
    """A same-size edit with its mtime put back re-reads that one file
    (its stat moved), and the step's tally says so."""
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE_WINDOW_NS", "0")
    ctx_dir = _context(tmp_path, n=5, size=100)
    tallies = []
    monkeypatch.setattr(add_copy.log, "info",
                        lambda msg, *a, **k: tallies.append(k)
                        if msg.startswith("stat cache") else None)
    _, ids1 = _build(tmp_path, "a")
    victim = ctx_dir / "f3.bin"
    st = victim.stat()
    victim.write_bytes(b"z" * 100)
    os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert victim.stat().st_mtime_ns == st.st_mtime_ns
    _, ids2 = _build(tmp_path, "b")
    assert ids1 != ids2
    assert tallies[0]["misses_by_reason"] == {"absent": 5}
    assert tallies[1] == {"directive": "COPY", "files": 5, "hits": 4,
                          "misses": 1,
                          "misses_by_reason": {"stat_changed": 1},
                          "bytes_rehashed": 100, "memo_sources": 0}


def test_default_window_rehashes_fresh_files(tmp_path, monkeypatch):
    """With the default 2 s window, files hashed within 2 s of their last
    change are racy and re-read; files older than that are hits."""
    ctx_dir = _context(tmp_path, n=6, size=10)
    old = time.time_ns() - 60 * 10**9
    for name in ("f0.bin", "f1.bin"):
        os.utime(ctx_dir / name, ns=(old, old))
    tallies = []
    monkeypatch.setattr(add_copy.log, "info",
                        lambda msg, *a, **k: tallies.append(k)
                        if msg.startswith("stat cache") else None)
    _build(tmp_path, "a")
    _build(tmp_path, "b")
    # ctime cannot be set back: every file changed just now, so all six
    # are racy on the warm build.
    assert tallies[1]["hits"] == 0
    assert tallies[1]["misses_by_reason"] == {"racy": 6}


def test_failed_build_still_saves_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MAKISU_TPU_STAT_CACHE_WINDOW_NS", "0")
    _context(tmp_path, n=3)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr("makisu_tpu_torch.steps.base.commit_layer", broken)
    with pytest.raises(OSError):
        _build(tmp_path, "a")
    with open(tmp_path / "store" / "content_id_cache.json") as f:
        assert len(json.load(f)["entries"]) == 3
