"""The layer commit's bounded mtime wait (``MemFS._sync``).

After its os.sync a commit waits only until the clock's second is past
the newest mtime second among the headers it folds into the tree (plus
``MemFS.MTIME_MARGIN``), never longer than ``MemFS.SYNC_WAIT``, and not
at all for a layer without content entries. Every commit opens the
``commit.mtime_wait`` span and counts ``COMMIT_MTIME_WAITS`` by outcome.
Cases run on the copy-op route (``add_layer_by_copy_ops``) and the scan
route (``add_layer_by_scan``) where both apply, on the real clock unless
they record ``time.sleep`` instead of sleeping."""

import io
import os
import shutil
import tarfile
import time

import pytest

from makisu_tpu_torch.snapshot import memfs
from makisu_tpu_torch.snapshot.copy_op import CopyOperation
from makisu_tpu_torch.utils import metrics, mountinfo

OLD = 1600000000  # 2020-09-13, the age of an old checkout's files
SLEEP = time.sleep  # the real one, which ``sleeps`` replaces
ROUTES = ("copy", "scan")


@pytest.fixture
def registry():
    mountinfo.set_mountpoints_for_testing(set())
    reg = metrics.MetricsRegistry()
    token = metrics.set_build_registry(reg)
    try:
        yield reg
    finally:
        metrics.reset_build_registry(token)
        mountinfo.set_mountpoints_for_testing(None)


@pytest.fixture
def sleeps(monkeypatch):
    """Record each ``time.sleep`` the commit asks for, as (seconds, the
    clock it would end at), instead of sleeping (``time`` is one module:
    the test's own sleeps take ``SLEEP``)."""
    asked = []
    monkeypatch.setattr(memfs.time, "sleep",
                        lambda s: asked.append((s, time.time() + s)))
    return asked


def early_in_a_second():
    """Sleep to ~50 ms into the next second, so that what follows within
    a few hundred ms shares one mtime second."""
    SLEEP(1.05 - time.time() % 1)


def write(path, data, mtime=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    if mtime is not None:
        os.utime(path, (mtime, mtime))


def commit(fs, route, ctx=None, names=()):
    """One layer commit into an in-memory tar: the copy-op route copies
    each of ``names`` (a file or a directory of ``ctx``) to the same path
    under the root, as a COPY step would (mtimes kept), and diffs the
    copies; the scan route diffs the root against the tree."""
    with tarfile.open(fileobj=io.BytesIO(), mode="w|") as tw:
        if route == "scan":
            return fs.add_layer_by_scan(tw)
        ops = []
        for name in names:
            src, dst = os.path.join(ctx, name), os.path.join(fs.root, name)
            if os.path.isdir(src):
                shutil.copytree(src, dst)
                name += "/"
            else:
                shutil.copy2(src, dst)
            ops.append(CopyOperation(
                [name], ctx, "/", "/" + name,
                chown=f"{os.getuid()}:{os.getgid()}"))
        return fs.add_layer_by_copy_ops(ops, tw)


def make(tmp_path, route, files):
    """A MemFS over a fresh root and the directory the files go to: the
    context (copy) or the root itself (scan)."""
    root = tmp_path / "root"
    root.mkdir()
    src = tmp_path / "ctx" if route == "copy" else root
    src.mkdir(exist_ok=True)
    for name, data, mtime in files:
        write(str(src / name), data, mtime)
    return memfs.MemFS(str(root)), str(src)


def wait_spans(reg):
    out = []

    def walk(span):
        if span["name"] == "commit.mtime_wait":
            out.append(span["duration"])
        for child in span.get("children", []):
            walk(child)

    for span in reg.report()["spans"]:
        walk(span)
    return out


def outcomes(reg):
    return {o: reg.counter_total(metrics.COMMIT_MTIME_WAITS, outcome=o)
            for o in ("skipped", "waited")}


@pytest.mark.parametrize("route", ROUTES)
def test_old_files_commit_without_a_wait(tmp_path, registry, route):
    """A layer of files dated 2020 (directories too: a RUN's tree and a
    COPY's synthesised ancestors are as old) commits at once."""
    fs, src = make(tmp_path, route, [
        ("app/a.txt", b"a" * 100, OLD), ("app/sub/b.bin", b"b" * 5000, OLD)])
    for d in ("app/sub", "app"):
        os.utime(os.path.join(src, d), (OLD, OLD))
    layer = commit(fs, route, src, ["app"])
    assert "/app/sub/b.bin" in layer.entries
    [wait] = wait_spans(registry)
    assert 0 < wait < 0.05
    assert fs.mtime_wait_seconds == pytest.approx(wait, abs=1e-5)
    assert fs.mtime_wait_seconds <= fs.sync_seconds < memfs.MemFS.SYNC_WAIT
    assert outcomes(registry) == {"skipped": 1, "waited": 0}


@pytest.mark.parametrize("route", ROUTES)
def test_same_size_rewrite_after_a_commit_is_seen(tmp_path, registry, route):
    """On the real clock: a file written in this second and committed,
    then rewritten in place with the same size at once, is in the next
    scan's layer (its mtime second is past the committed header's)."""
    early_in_a_second()
    fs, src = make(tmp_path, route, [("f.txt", b"first!", None)])
    first = commit(fs, route, src, ["f.txt"])
    assert "/f.txt" in first.entries
    assert outcomes(registry) == {"skipped": 0, "waited": 1}
    assert fs.mtime_wait_seconds <= memfs.MemFS.SYNC_WAIT
    write(os.path.join(fs.root, "f.txt"), b"again!")
    assert "/f.txt" in commit(fs, "scan").entries


@pytest.mark.parametrize("route", ROUTES)
def test_future_dated_file_waits_at_most_sync_wait(tmp_path, registry,
                                                   sleeps, route):
    """A file dated an hour ahead (clock skew, ``touch -d``) asks for no
    more than ``SYNC_WAIT``, the flat wait the reference always takes."""
    future = int(time.time()) + 3600
    fs, src = make(tmp_path, route, [
        ("old.txt", b"old", OLD), ("ahead.txt", b"ahead", future)])
    layer = commit(fs, route, src, ["old.txt", "ahead.txt"])
    assert layer.entries["/ahead.txt"].hdr.mtime == future
    [(seconds, _)] = sleeps
    assert 0 < seconds <= memfs.MemFS.SYNC_WAIT
    assert outcomes(registry) == {"skipped": 0, "waited": 1}


def test_directory_a_run_just_changed_sets_the_deadline(tmp_path, registry,
                                                        sleeps):
    """Scan route: a RUN-like write adds a file dated 2020 to an old
    directory, whose own mtime is now; that directory's second, plus one
    and the margin, is where the wait ends."""
    fs, src = make(tmp_path, "scan", [("d/kept.txt", b"kept", OLD)])
    os.utime(os.path.join(src, "d"), (OLD, OLD))
    commit(fs, "scan")
    assert sleeps == []
    early_in_a_second()
    write(os.path.join(src, "d", "new.txt"), b"new", OLD)
    dir_second = int(os.stat(os.path.join(src, "d")).st_mtime)
    layer = commit(fs, "scan")
    assert {"/d", "/d/new.txt"} <= set(layer.entries)
    [(_, until)] = sleeps
    assert until == pytest.approx(
        dir_second + 1 + memfs.MemFS.MTIME_MARGIN, abs=0.01)
    assert outcomes(registry) == {"skipped": 1, "waited": 1}


def test_whiteout_only_layer_waits_nothing(tmp_path, registry, sleeps):
    """Scan route: a layer holding only a whiteout (a file deleted from
    the root, whose own header never enters a layer) has no mtime to
    wait past."""
    fs, src = make(tmp_path, "scan", [("gone.txt", b"gone", OLD)])
    commit(fs, "scan")
    os.remove(os.path.join(src, "gone.txt"))
    layer = commit(fs, "scan")
    assert [type(e) for e in layer.entries.values()] == [
        memfs.WhiteoutEntry]
    assert sleeps == []
    assert len(wait_spans(registry)) == 2
    assert outcomes(registry) == {"skipped": 2, "waited": 0}
