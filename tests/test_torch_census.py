"""The port's storage census (``makisu_tpu_torch/cache/census.py``), its
``du`` and ``doctor --storage`` commands and the worker's storage plane,
on the CPU, held against the JAX package's.

Every case of ``tests/test_census.py`` runs against the port: the
fixtures build a real storage root through the port's production write
paths (``ChunkStore.put`` + ``RecipeStore.publish`` for the chunk, pack
and recipe planes, plain CAS writes for blobs, the ``ManifestStore``
layout for manifests), then measure, break and re-measure it. The fleet
doctor case feeds the port worker's /healthz digest to the reference's
fleet doctor. Then both packages read one numpy-seeded storage dir: the
census documents (``du --json``) are equal but for the walk's
timestamp, ``du`` and ``doctor --storage`` print the same text, and
both workers' ``/storage`` and ``/healthz`` ``storage`` carry the same
keys.
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from makisu_tpu_torch.cache import census as census_mod
from makisu_tpu_torch.cache.census import IOBudget, StorageCensus
from makisu_tpu_torch.cache.chunks import ChunkStore
from makisu_tpu_torch.serve import recipe as recipe_mod
from makisu_tpu_torch.utils import events, zstdio


@pytest.fixture(autouse=True)
def _worker_side_effects(monkeypatch):
    """A worker of either package sets MAKISU_TPU_SHARED_HASH=1 and turns
    recipe publishing on for its process: both are restored after each
    test, so no later test's builds inherit them."""
    from makisu_tpu.serve import server as ref_serve_server
    from makisu_tpu_torch.serve import server as serve_server
    monkeypatch.setenv("MAKISU_TPU_SHARED_HASH", "0")
    for mod in (serve_server, ref_serve_server):
        monkeypatch.setattr(mod, "_publishing", mod._publishing)


def _pair(seed):
    from makisu_tpu_torch.docker.image import (
        MEDIA_TYPE_LAYER, Descriptor, Digest, DigestPair)
    return DigestPair(
        tar_digest=Digest.from_hex(f"{seed:02x}" * 32),
        gzip_descriptor=Descriptor(
            MEDIA_TYPE_LAYER, 10,
            Digest.from_hex(f"{seed + 1:02x}" * 32)))


def _populate(tmp_path, tenant=""):
    """One published layer: two chunks, one pack (+zpack twin when
    zstd is available), one recipe; plus one blob + manifest pair.
    Returns (storage_dir, recipe_doc, fingerprints)."""
    storage = tmp_path / "storage"
    store = ChunkStore(str(storage / "chunks"))
    rs = recipe_mod.RecipeStore(str(storage / "serve"),
                                str(storage / "chunks"))
    c1, c2 = b"a" * 1000, b"b" * 3000
    fps = [hashlib.sha256(c).hexdigest() for c in (c1, c2)]
    for fp, data in zip(fps, (c1, c2)):
        store.put(fp, data)
    pair = _pair(0x10)
    doc = rs.publish(pair, [(0, 1000, fps[0]), (1000, 3000, fps[1])],
                     None, store)
    assert doc is not None

    blob_hex, config_hex = "cd" * 32, "ee" * 32
    for hx, size in ((blob_hex, 500), (config_hex, 80)):
        blob_dir = storage / "layers" / hx[:2]
        blob_dir.mkdir(parents=True, exist_ok=True)
        (blob_dir / hx).write_bytes(b"z" * size)
    man_dir = storage / "manifests" / "team" / "app"
    man_dir.mkdir(parents=True)
    (man_dir / "latest.json").write_text(json.dumps({
        "layers": [{"digest": f"sha256:{blob_hex}"}],
        "config": {"digest": f"sha256:{config_hex}"},
    }))
    if tenant:
        census_mod.record_attribution(
            str(storage), tenant,
            [doc["layer"]["tar"], blob_hex, config_hex])
    return str(storage), doc, fps


# -- census -------------------------------------------------------------------


def test_census_totals_match_disk(tmp_path):
    storage, doc, fps = _populate(tmp_path)
    out = StorageCensus(storage).census()
    assert out["schema"] == census_mod.CENSUS_SCHEMA
    assert out["planes"]["chunks"] == {
        "objects": 2, "bytes": 4000,
        "snapshots": 0, "snapshot_bytes": 0,
        "age": {"1h": 2, "1d": 0, "1w": 0, "30d": 0, "older": 0}}
    assert out["planes"]["blobs"]["objects"] == 2
    assert out["planes"]["blobs"]["bytes"] == 580
    assert out["planes"]["recipes"]["objects"] == 1
    packs = out["planes"]["packs"]
    assert packs["tables"] == 1
    # On-disk truth: every file the walk should count, counted once.
    want = 0
    for dirpath, _, files in os.walk(storage):
        if os.path.basename(dirpath) == "_tmp":
            continue
        for fn in files:
            if fn in (census_mod.CENSUS_CACHE_FILE,
                      census_mod.ATTRIBUTION_FILE) \
                    or "manifests" in dirpath:
                continue
            want += os.path.getsize(os.path.join(dirpath, fn))
    assert out["total_bytes"] == want
    # The cache file is the cheap-consumer path.
    totals = census_mod.cached_totals(storage)
    assert totals["total"] == out["total_bytes"]
    assert totals["chunks"] == 4000


def test_census_age_histogram_buckets(tmp_path):
    storage, _, fps = _populate(tmp_path)
    old = os.path.join(storage, "chunks", fps[0][:2], fps[0])
    past = os.path.getmtime(old) - 40 * 86400
    os.utime(old, (past, past))
    out = StorageCensus(storage).census()
    age = out["planes"]["chunks"]["age"]
    assert age["older"] == 1 and age["1h"] == 1


def test_census_attribution_joins_tenant(tmp_path):
    storage, _, _ = _populate(tmp_path, tenant="team-a")
    out = StorageCensus(storage).census()
    tenants = out["tenants"]
    assert "team-a" in tenants
    # The recipe's chunks, pack objects, recipe file, and the blob all
    # charge to team-a; nothing else exists, so unattributed is absent.
    assert tenants["team-a"]["bytes"] == out["total_bytes"]
    assert census_mod.UNATTRIBUTED not in tenants


def test_census_unattributed_bucket(tmp_path):
    storage, _, _ = _populate(tmp_path)
    out = StorageCensus(storage).census()
    assert set(out["tenants"]) == {census_mod.UNATTRIBUTED}


def test_cap_label_folds_tail():
    assert census_mod.cap_label("") == census_mod.UNATTRIBUTED
    assert census_mod.cap_label("team-a", 0) == "team-a"
    assert census_mod.cap_label("team-z", 99) == \
        census_mod.TENANT_OVERFLOW
    assert len(census_mod.cap_label("x" * 200, 0)) == 64


def test_torn_attribution_sidecar_reads_empty(tmp_path):
    storage = tmp_path / "s"
    storage.mkdir()
    (storage / census_mod.ATTRIBUTION_FILE).write_text('{"layers": {"')
    assert census_mod.load_attribution(str(storage)) == {}


def test_cached_totals_absent_without_census(tmp_path):
    assert census_mod.cached_totals(str(tmp_path)) is None


# -- IO budget ----------------------------------------------------------------


def test_iobudget_oversized_object_admitted_alone():
    budget = IOBudget(max_resident_bytes=1024)
    budget.acquire(4096)  # larger than the whole budget: no deadlock
    assert budget.resident == 4096
    budget.release(4096)
    assert budget.resident == 0


def test_iobudget_reserve_is_balanced(tmp_path):
    budget = IOBudget(max_resident_bytes=1 << 20)
    big = tmp_path / "big"
    big.write_bytes(b"q" * (3 << 20))  # 3 pieces through a 1MiB budget
    digest, size = census_mod._hash_file(str(big), budget)
    assert size == 3 << 20
    assert digest == hashlib.sha256(b"q" * (3 << 20)).hexdigest()
    assert budget.resident == 0


def test_iobudget_throttle_sleeps_over_limit(monkeypatch):
    naps = []
    monkeypatch.setattr(census_mod.time, "sleep", naps.append)
    budget = IOBudget(bytes_per_second=100)
    budget.throttle(50)
    assert not naps
    budget.throttle(200)
    assert naps and naps[0] > 0


# -- reference audit ----------------------------------------------------------


def test_audit_clean_store_has_no_findings(tmp_path):
    storage, _, _ = _populate(tmp_path)
    out = StorageCensus(storage).audit()
    assert out["findings"] == []
    assert out["classification"]["chunks"]["live"] == 2
    assert out["classification"]["chunks"]["orphaned"] == 0
    assert out["classification"]["recipes"]["live"] == 1
    assert out["classification"]["blobs"]["live"] == 2


def test_audit_names_dangling_chunk(tmp_path):
    storage, _, fps = _populate(tmp_path)
    os.unlink(os.path.join(storage, "chunks", fps[0][:2], fps[0]))
    # A missing chunk whose pack survives as a compressed twin is
    # DEMOTED (recoverable), not dangling — remove the twin so the
    # loss is genuinely unrecoverable.
    shutil.rmtree(os.path.join(storage, "serve", "zpacks"),
                  ignore_errors=True)
    out = StorageCensus(storage).audit()
    kinds = {f["kind"] for f in out["findings"]}
    assert "dangling_chunk" in kinds
    assert "dangling_pack_member" in kinds
    dangling = next(f for f in out["findings"]
                    if f["kind"] == "dangling_chunk")
    assert dangling["chunk"] == fps[0]
    assert dangling["severity"] == "error"
    assert out["classification"]["recipes"]["dangling"] == 1
    assert out["classification"]["packs"]["dangling"] == 1


@pytest.mark.skipif(not zstdio.available(), reason="no zstd")
def test_audit_missing_chunk_with_twin_is_demoted(tmp_path):
    """A chunk absent from the CAS whose pack has a seekable twin is
    the budget evictor's expected footprint: classified demoted, zero
    findings — a post-eviction `doctor --storage` must exit clean."""
    storage, _, fps = _populate(tmp_path)
    os.unlink(os.path.join(storage, "chunks", fps[0][:2], fps[0]))
    out = StorageCensus(storage).audit()
    assert out["findings"] == []
    assert out["classification"]["chunks"]["demoted"] == 1
    assert out["classification"]["recipes"]["dangling"] == 0
    assert out["classification"]["packs"]["dangling"] == 0


def test_audit_names_dangling_blob(tmp_path):
    storage, _, _ = _populate(tmp_path)
    blob_hex = "cd" * 32
    os.unlink(os.path.join(storage, "layers", blob_hex[:2], blob_hex))
    out = StorageCensus(storage).audit()
    dangling = [f for f in out["findings"]
                if f["kind"] == "dangling_blob"]
    assert [f["object"] for f in dangling] == [blob_hex]


def test_audit_corrupt_index_per_plane_never_crashes(tmp_path):
    """A mid-write truncation of each index plane (recipe
    JSON, pack table) must classify as corrupt_index — not crash."""
    storage, doc, _ = _populate(tmp_path)
    recipe_path = os.path.join(storage, "serve", "recipes",
                               f"{doc['layer']['gzip']}.json")
    pack_hex = doc["chunks"][0][2]
    table_path = os.path.join(storage, "serve", "packs",
                              f"{pack_hex}.json")
    for path in (recipe_path, table_path):
        whole = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(whole[:len(whole) // 2])  # torn mid-write
    census = StorageCensus(storage)
    out = census.audit()
    corrupt = [f for f in out["findings"]
               if f["kind"] == "corrupt_index"]
    assert {f["plane"] for f in corrupt} == {"recipes", "packs"}
    assert all(f["severity"] == "error" for f in corrupt)
    # The census survives the same torn files.
    census.census()


def test_audit_orphaned_zpack_and_repair(tmp_path):
    storage, _, _ = _populate(tmp_path)
    zdir = os.path.join(storage, "serve", "zpacks")
    os.makedirs(zdir, exist_ok=True)
    orphan_hex = "ab" * 32
    orphan = os.path.join(zdir, f"{orphan_hex}.zst")
    with open(orphan, "wb") as f:
        f.write(b"x" * 77)
    census = StorageCensus(storage)
    out = census.audit()
    found = [f for f in out["findings"]
             if f["kind"] == "orphaned_zpack"]
    assert len(found) == 1
    assert found[0]["object"] == orphan_hex
    assert found[0]["repairable"] is True
    assert found[0]["bytes"] == 77
    # Dry-run (default): lists, does not delete.
    dry = census.repair_orphaned_zpacks(found, apply=False)
    assert not dry["applied"]
    assert dry["freed_bytes"] == 77
    assert os.path.exists(orphan)
    # Apply: deletes the twin.
    applied = census.repair_orphaned_zpacks(found, apply=True)
    assert applied["applied"] and applied["freed_bytes"] == 77
    assert not os.path.exists(orphan)


def test_repair_skips_twin_whose_table_landed(tmp_path):
    """The audit→repair race: a table published between the audit and
    the repair re-legitimizes the twin — repair must re-verify NOW."""
    storage, _, _ = _populate(tmp_path)
    zdir = os.path.join(storage, "serve", "zpacks")
    os.makedirs(zdir, exist_ok=True)
    hx = "ab" * 32
    orphan = os.path.join(zdir, f"{hx}.zst")
    with open(orphan, "wb") as f:
        f.write(b"x")
    census = StorageCensus(storage)
    found = [f for f in census.audit()["findings"]
             if f["kind"] == "orphaned_zpack"]
    with open(os.path.join(storage, "serve", "packs",
                           f"{hx}.json"), "w") as f:
        f.write("[]")  # table lands after the audit
    out = census.repair_orphaned_zpacks(found, apply=True)
    assert out["skipped"] == 1 and not out["removed"]
    assert os.path.exists(orphan)


@pytest.mark.skipif(not zstdio.available(), reason="no zstd")
def test_audit_truncated_zpack(tmp_path):
    storage, doc, _ = _populate(tmp_path)
    pack_hex = doc["chunks"][0][2]
    zpath = os.path.join(storage, "serve", "zpacks",
                         f"{pack_hex}.zst")
    assert os.path.exists(zpath)
    size = os.path.getsize(zpath)
    with open(zpath, "rb+") as f:
        f.truncate(size - 1)
    out = StorageCensus(storage).audit()
    kinds = {f["kind"] for f in out["findings"]}
    assert "truncated_zpack" in kinds


# -- eviction dry-run ---------------------------------------------------------


def test_eviction_dry_run_lru_order_and_sum(tmp_path):
    storage, _, fps = _populate(tmp_path)
    oldest = os.path.join(storage, "chunks", fps[1][:2], fps[1])
    past = os.path.getmtime(oldest) - 3600
    os.utime(oldest, (past, past))
    out = StorageCensus(storage).eviction_dry_run(3000)
    assert not out["refused"]
    assert out["current_bytes"] == 4580  # 4000 chunks + 580 blobs
    # LRU: the back-dated 3000-byte chunk goes first and suffices.
    assert out["would_evict"][0]["object"] == fps[1]
    assert out["freed_bytes"] >= 1500
    assert out["remaining_bytes"] == \
        out["current_bytes"] - out["freed_bytes"]
    assert out["remaining_bytes"] <= 3000


def test_eviction_dry_run_refuses_unseeded(tmp_path):
    storage, _, _ = _populate(tmp_path)
    out = StorageCensus(storage).eviction_dry_run(
        0, seed_state={"state": "seeding", "seeded_entries": 3})
    assert out["refused"]
    assert "seeding" in out["reason"]


def test_cas_seed_state_small_store_is_seeded(tmp_path):
    from makisu_tpu_torch.storage.cas import CASStore
    store = CASStore(str(tmp_path / "cas"), max_entries=8)
    store.write_bytes("aa" * 32, b"x")
    state = store.seed_state()
    assert state["state"] == "seeded"
    assert state["seeded_entries"] == 1


# -- integrity scrub ----------------------------------------------------------


def test_scrub_clean_store(tmp_path):
    storage, _, _ = _populate(tmp_path)
    out = StorageCensus(storage).scrub(chunk_samples=10)
    assert out["chunks_checked"] == 2
    assert out["findings"] == []
    assert out["bytes_read"] >= 4000


def test_scrub_names_corrupt_chunk(tmp_path):
    storage, _, fps = _populate(tmp_path)
    victim = os.path.join(storage, "chunks", fps[0][:2], fps[0])
    with open(victim, "rb+") as f:
        f.write(b"!")  # flip the first byte
    captured = []
    token = events.add_sink(captured.append)
    try:
        out = StorageCensus(storage).scrub(chunk_samples=10)
    finally:
        events.reset_sink(token)
    # The chunk finding is required; the zpack spot-check may ALSO
    # flag the same rot (the twin no longer matches the re-synthesized
    # raw range) — that second finding is correct, not double-counting.
    corrupt = [f for f in out["findings"]
               if f["kind"] == "corruption"
               and f["plane"] == "chunks"]
    assert len(corrupt) == 1
    assert corrupt[0]["expected"] == fps[0]
    assert corrupt[0]["actual"] != fps[0]
    assert corrupt[0]["path"] == victim
    # Findings ride the event bus as storage_finding events.
    kinds = [e for e in captured
             if e.get("type") == census_mod.EVENT_TYPE]
    assert kinds and kinds[0]["object"] == fps[0]


@pytest.mark.skipif(not zstdio.available(), reason="no zstd")
def test_scrub_names_corrupt_zpack_frame(tmp_path):
    storage, doc, _ = _populate(tmp_path)
    pack_hex = doc["chunks"][0][2]
    zpath = os.path.join(storage, "serve", "zpacks",
                         f"{pack_hex}.zst")
    with open(zpath, "rb+") as f:
        f.seek(os.path.getsize(zpath) // 2)
        f.write(b"\xff\xff\xff\xff")
    out = StorageCensus(storage).scrub(chunk_samples=0,
                                       pack_samples=4)
    corrupt = [f for f in out["findings"]
               if f["kind"] == "corruption" and f["plane"] == "packs"]
    assert corrupt
    assert corrupt[0]["object"] == pack_hex


# -- worker integration -------------------------------------------------------


def test_worker_healthz_and_storage_endpoint(tmp_path):
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer
    storage, _, fps = _populate(tmp_path)
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    thread = server.serve_background()
    try:
        server._add_storage_dir(storage)
        client = WorkerClient(server.socket_path)
        health = client.healthz()
        section = health["storage"]
        assert section["planes"]["chunks"]["objects"] == 2
        assert section["total_bytes"] > 0
        assert section["lru_seed"]["state"] == "seeded"
        assert section["findings"]["total"] == 0
        # Break a reference (twin removed too — a recoverable miss
        # is demoted, not a finding); /storage re-walks and names it.
        os.unlink(os.path.join(storage, "chunks",
                               fps[0][:2], fps[0]))
        shutil.rmtree(os.path.join(storage, "serve", "zpacks"),
                      ignore_errors=True)
        report = client.storage(eviction_budget=0)
        (entry,) = report["storage"]
        kinds = {f["kind"] for f in entry["audit"]["findings"]}
        assert "dangling_chunk" in kinds
        assert not entry["eviction_dry_run"]["refused"]
        assert entry["eviction_dry_run"]["remaining_bytes"] == 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def test_fleet_doctor_flags_storage(tmp_path):
    """The fleet doctor reads a worker's /healthz ``storage`` digest.
    The port's worker serves it: fed to the port's fleet doctor, a
    digest with findings and an unseeded chunk-CAS LRU map is flagged
    both ways, in the reference fleet doctor's words."""
    from makisu_tpu.fleet import doctor as ref_fleet_doctor
    from makisu_tpu_torch.fleet import doctor as fleet_doctor
    from makisu_tpu_torch.cache import chunks as chunks_mod
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer
    storage, _, fps = _populate(tmp_path)
    live = ChunkStore(os.path.join(storage, "chunks"))
    chunks_mod.register_serving_store(live)
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    thread = server.serve_background()
    try:
        server._add_storage_dir(storage)
        os.unlink(os.path.join(storage, "chunks", fps[0][:2], fps[0]))
        shutil.rmtree(os.path.join(storage, "serve", "zpacks"),
                      ignore_errors=True)
        client = WorkerClient(server.socket_path)
        client.storage()  # the audit parks its findings for /healthz
        section = client.healthz()["storage"]
        assert section["lru_seed"]["state"] == "unseeded"
        assert section["findings"]["total"] > 0
    finally:
        with chunks_mod._serving_lock:
            chunks_mod._serving_stores.pop(
                os.path.realpath(live.cas.root), None)
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    health = {"fleet": {"workers": [{
        "id": "w0", "alive": True, "state": "alive",
        "storage": section}]}, "self": {}}
    kinds = {f["kind"] for f in fleet_doctor.diagnose_fleet(health)}
    assert "storage_findings" in kinds
    assert "storage_unseeded" in kinds
    rendered = fleet_doctor.render_fleet_doctor(health, "sock")
    assert "STORAGE" in rendered
    assert rendered == ref_fleet_doctor.render_fleet_doctor(health, "sock")


# -- CLI ----------------------------------------------------------------------


def test_cli_du_json_and_human(tmp_path, capsys):
    from makisu_tpu_torch import cli
    storage, _, _ = _populate(tmp_path)
    assert cli.main(["du", "--storage", storage, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == census_mod.CENSUS_SCHEMA
    assert doc["planes"]["chunks"]["bytes"] == 4000
    assert cli.main(["du", "--storage", storage]) == 0
    human = capsys.readouterr().out
    assert "chunks" in human
    assert "unattributed" in human


def test_cli_doctor_storage_exit_codes(tmp_path, capsys):
    from makisu_tpu_torch import cli
    storage, _, fps = _populate(tmp_path)
    assert cli.main(["doctor", "--storage", storage]) == 0
    out = capsys.readouterr().out
    assert "no findings" in out
    os.unlink(os.path.join(storage, "chunks", fps[0][:2], fps[0]))
    shutil.rmtree(os.path.join(storage, "serve", "zpacks"),
                  ignore_errors=True)
    assert cli.main(["doctor", "--storage", storage]) == 1
    out = capsys.readouterr().out
    assert "dangling_chunk" in out
    assert fps[0][:12] in out


def test_cli_doctor_storage_repair(tmp_path, capsys):
    from makisu_tpu_torch import cli
    storage, _, _ = _populate(tmp_path)
    zdir = os.path.join(storage, "serve", "zpacks")
    os.makedirs(zdir, exist_ok=True)
    orphan = os.path.join(zdir, "ab" * 32 + ".zst")
    with open(orphan, "wb") as f:
        f.write(b"x" * 9)
    # Findings exist → exit 1; dry-run leaves the twin in place.
    assert cli.main(["doctor", "--storage", storage]) == 1
    assert "would delete" in capsys.readouterr().out
    assert os.path.exists(orphan)
    assert cli.main(["doctor", "--storage", storage,
                     "--repair"]) == 1
    assert "deleted" in capsys.readouterr().out
    assert not os.path.exists(orphan)
    # Repaired store is clean again.
    assert cli.main(["doctor", "--storage", storage]) == 0


# -- the two packages on one storage dir --------------------------------------


def _seeded_storage(tmp_path, seed=21, tenant="team-s"):
    """A numpy-seeded storage through the port's write paths: one
    published layer of random chunks (pack, zpack twin, recipe), blobs
    and a manifest, a session-snapshot recipe, tenant attribution, and
    object mtimes spread over every age bucket."""
    rng = np.random.default_rng(seed)
    storage = tmp_path / "storage"
    store = ChunkStore(str(storage / "chunks"))
    rs = recipe_mod.RecipeStore(str(storage / "serve"),
                                str(storage / "chunks"))
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(500, 5000, 10)]
    fps = [hashlib.sha256(p).hexdigest() for p in payloads]
    triples, off = [], 0
    for fp, data in zip(fps, payloads):
        store.put(fp, data)
        triples.append((off, len(data), fp))
        off += len(data)
    doc = rs.publish(_pair(0x30), triples, None, store)
    assert doc is not None
    blobs = {}
    for _ in range(3):
        hx = rng.integers(0, 256, 32, dtype=np.uint8).tobytes().hex()
        blobs[hx] = int(rng.integers(100, 900))
        blob_dir = storage / "layers" / hx[:2]
        blob_dir.mkdir(parents=True, exist_ok=True)
        (blob_dir / hx).write_bytes(b"z" * blobs[hx])
    names = sorted(blobs)
    man_dir = storage / "manifests" / "team" / "app"
    man_dir.mkdir(parents=True)
    (man_dir / "v1.json").write_text(json.dumps({
        "layers": [{"digest": f"sha256:{names[0]}"}],
        "config": {"digest": f"sha256:{names[1]}"}}))
    snap_dir = storage / "serve" / "snapshots"
    snap_dir.mkdir(parents=True)
    (snap_dir / f"{'5a' * 32}.json").write_text(json.dumps({
        "context": "/ctx", "shards": {"memo": {"chunk": fps[3]}}}))
    census_mod.record_attribution(str(storage), tenant,
                                  [doc["layer"]["tar"], names[0]])
    now = os.path.getmtime(storage / "chunks" / fps[0][:2] / fps[0])
    for i, fp in enumerate(fps):
        past = now - [60, 7200, 2 * 86400, 9 * 86400, 40 * 86400][i % 5]
        os.utime(storage / "chunks" / fp[:2] / fp, (past, past))
    return str(storage), doc, fps


def _run(pkg_cli, argv, capsys):
    code = pkg_cli.main(argv)
    return code, capsys.readouterr().out


@pytest.mark.parametrize("state", ["clean", "demoted", "broken"])
def test_census_documents_equal_across_packages(tmp_path, capsys, state):
    from makisu_tpu import cli as ref_cli
    from makisu_tpu_torch import cli
    from makisu_tpu_torch.storage import contentstore
    storage, doc, fps = _seeded_storage(tmp_path)
    if state == "demoted":
        contentstore.store_for(storage).evict(budget_bytes=9000)
    elif state == "broken":
        os.unlink(os.path.join(storage, "chunks", fps[1][:2], fps[1]))
        shutil.rmtree(os.path.join(storage, "serve", "zpacks"))
    docs = {}
    for name, pkg_cli in (("port", cli), ("reference", ref_cli)):
        code, out = _run(pkg_cli, ["du", "--storage", storage, "--json"],
                         capsys)
        assert code == 0
        docs[name] = json.loads(out)
        docs[name].pop("generated_ts")
    assert docs["port"] == docs["reference"]
    assert docs["port"]["planes"]["chunks"]["snapshots"] == 1
    assert docs["port"]["tenants"]["team-s"]["bytes"] > 0


@pytest.mark.parametrize("argv", [
    pytest.param(["du"], id="du"),
    pytest.param(["doctor", "--storage"], id="doctor"),
    pytest.param(["doctor", "--storage", "--eviction-budget", "12000"],
                 id="doctor-eviction-budget"),
])
@pytest.mark.parametrize("state", ["clean", "broken", "orphaned-zpack"])
def test_du_and_doctor_text_identical(tmp_path, capsys, argv, state):
    from makisu_tpu import cli as ref_cli
    from makisu_tpu_torch import cli
    storage, doc, fps = _seeded_storage(tmp_path, seed=23)
    if state == "broken":
        os.unlink(os.path.join(storage, "chunks", fps[2][:2], fps[2]))
        shutil.rmtree(os.path.join(storage, "serve", "zpacks"))
    elif state == "orphaned-zpack":
        with open(os.path.join(storage, "serve", "zpacks",
                               "ab" * 32 + ".zst"), "wb") as f:
            f.write(b"x" * 33)
    full = argv[:1] + (["--storage", storage] if argv == ["du"]
                       else argv[1:2] + [storage] + argv[2:])
    outs = {}
    for name, pkg_cli in (("port", cli), ("reference", ref_cli)):
        outs[name] = _run(pkg_cli, full, capsys)
    assert outs["port"] == outs["reference"]
    code, text = outs["port"]
    assert code == (0 if state == "clean" or argv == ["du"] else 1)
    assert text


def _keys(doc):
    """The key tree of a JSON document (values dropped; a list of
    objects keeps its first object's keys)."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list) and doc and isinstance(doc[0], dict):
        return [_keys(doc[0])]
    return None


def test_storage_plane_keys_match_the_reference_worker(tmp_path):
    from makisu_tpu.worker import WorkerClient as RefWorkerClient
    from makisu_tpu.worker import WorkerServer as RefWorkerServer
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer
    storage, _, fps = _seeded_storage(tmp_path, seed=29)
    port = WorkerServer(str(tmp_path / "p.sock"), device="cpu")
    ref = RefWorkerServer(str(tmp_path / "r.sock"))
    threads = [port.serve_background(), ref.serve_background()]
    try:
        sections = {}
        for name, srv, client_cls in (("port", port, WorkerClient),
                                      ("reference", ref, RefWorkerClient)):
            srv._add_storage_dir(storage)
            client = client_cls(srv.socket_path)
            sections[name] = (client.healthz()["storage"],
                              client.storage(eviction_budget=5000))
        (p_health, p_report), (r_health, r_report) = \
            sections["port"], sections["reference"]
        assert _keys(p_health) == _keys(r_health)
        assert p_health["planes"] == r_health["planes"]
        (p_entry,), (r_entry,) = p_report["storage"], r_report["storage"]
        assert set(p_entry) == {"storage_dir", "census", "audit",
                                "eviction_dry_run", "contentstore",
                                "scrub"}
        assert _keys(p_entry) == _keys(r_entry)
        dry = [dict(e["eviction_dry_run"]) for e in (p_entry, r_entry)]
        for d in dry:
            d["would_evict"] = [
                {k: v for k, v in row.items() if k != "age_seconds"}
                for row in d["would_evict"]]
        assert dry[0] == dry[1] and dry[0]["evict_count"] > 0
    finally:
        for srv in (port, ref):
            srv.shutdown()
            srv.server_close()
        for t in threads:
            t.join(timeout=5)


def test_storage_budget_rule_reads_the_worker_storage(tmp_path):
    """The worker's SLO probe carries the storage planes' bytes, so the
    ``storage_budget`` rule alerts once they pass its threshold."""
    from makisu_tpu_torch.fleet import slo
    from makisu_tpu_torch.worker import WorkerServer
    storage, _, _ = _populate(tmp_path)
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu",
                          slo_interval=3600)
    try:
        server._add_storage_dir(storage)
        total = server.storage_health()["total_bytes"]
        assert total > 0
        assert server._slo_probe()["levels"]["storage_total_bytes"] == total
        (rule,) = [r for r in slo.default_worker_rules()
                   if r.name == "storage_budget"]
        for threshold, fired in ((rule.threshold, False),
                                 (total - 1, True)):
            low = slo.SloRule(rule.name, rule.kind, severity=rule.severity,
                              threshold=threshold, signal=rule.signal,
                              message=rule.message)
            evaluator = slo.SloEvaluator(server._slo_probe, [low],
                                         interval=3600)
            evaluator.tick()
            active = [a["rule"] for a in
                      evaluator.manager.snapshot()["active"]]
            assert active == (["storage_budget"] if fired else [])
    finally:
        server.server_close()


def test_scrub_eviction_waits_for_a_build_on_the_storage(tmp_path,
                                                          monkeypatch):
    """The scrub cycle's budget pass skips a storage dir while a build
    holds its path lock (a blob is no pin: evicting one a running
    build's cache hit will read fails that build); the next cycle after
    the build evicts. The scrub itself runs either way."""
    from makisu_tpu_torch.storage import contentstore
    from makisu_tpu_torch.worker import WorkerServer
    storage, _, fps = _populate(tmp_path)
    monkeypatch.setenv("MAKISU_TPU_STORAGE_SCRUB_SECONDS", "0")
    monkeypatch.setenv("MAKISU_TPU_STORAGE_EVICT_SECONDS", "0")
    monkeypatch.setattr(contentstore, "_dir_budgets",
                        {os.path.realpath(storage): 1})
    monkeypatch.setattr(contentstore, "_stores", {})
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    try:
        server._add_storage_dir(storage)
        (key,) = server.storage_dirs()
        blob = os.path.join(storage, "layers", "cd", "cd" * 32)
        locks = server._shared_path_locks(
            ["build", str(tmp_path), "-t", "a:1", "--storage", storage])
        for lock in locks:
            lock.acquire()
        try:
            server._scrub_once(key)
        finally:
            for lock in locks:
                lock.release()
        assert os.path.exists(blob)
        assert server.storage_report()["storage"][0]["scrub"][
            "chunks_checked"] == 2
        server._scrub_once(key)
        assert not os.path.exists(blob)
    finally:
        server.server_close()


def test_worker_build_attributes_its_layers_to_its_tenant(tmp_path):
    """A tenant's build through the worker records its layers' hexes
    under the tenant (the cache-decision ledger joined to the census):
    ``du`` then charges the layer's blob and chunks to that tenant."""
    from makisu_tpu_torch.utils import mountinfo
    from makisu_tpu_torch.worker import WorkerClient, WorkerServer
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY f.bin /f.bin\n")
    (ctx / "f.bin").write_bytes(np.random.default_rng(4).integers(
        0, 256, 40_000, dtype=np.uint8).tobytes())
    (tmp_path / "root").mkdir()
    storage = tmp_path / "storage"
    mountinfo.set_mountpoints_for_testing(set())
    server = WorkerServer(str(tmp_path / "w.sock"), device="cpu")
    thread = server.serve_background()
    try:
        client = WorkerClient(server.socket_path)
        assert client.build(["build", str(ctx), "-t", "att/app:1",
                             "--hasher", "gpu", "--storage", str(storage),
                             "--root", str(tmp_path / "root")],
                            tenant="team-x") == 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
        mountinfo.set_mountpoints_for_testing(None)
    manifest = json.loads(
        (storage / "manifests" / "att" / "app" / "1.json").read_text())
    (layer,) = [d["digest"].split(":")[1] for d in manifest["layers"]]
    attr = census_mod.load_attribution(str(storage))
    assert attr.get(layer) == "team-x"
    doc = StorageCensus(str(storage)).census()
    assert doc["tenants"]["team-x"]["bytes"] >= \
        os.path.getsize(storage / "layers" / layer[:2] / layer)


def test_history_record_carries_the_cached_census(tmp_path, capsys):
    """A build's history record takes the storage planes' bytes from the
    census cache (``<storage>/census.json``, written by ``du``), never
    from a walk of its own."""
    from makisu_tpu_torch import cli
    from makisu_tpu_torch.utils import mountinfo
    from makisu_tpu_torch.worker import session
    storage, _, _ = _populate(tmp_path)
    assert cli.main(["du", "--storage", storage, "--json"]) == 0
    cached = census_mod.cached_totals(storage)
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY f /f\n")
    (ctx / "f").write_text("x")
    (tmp_path / "root").mkdir()
    history = tmp_path / "H.jsonl"
    mountinfo.set_mountpoints_for_testing(set())
    mgr = session.SessionManager()
    token = session.bind_manager(mgr)
    try:
        assert cli.main(["--history-out", str(history), "build", str(ctx),
                         "-t", "h/app:1", "--hasher", "cpu", "--storage",
                         storage, "--root", str(tmp_path / "root")],
                        device="cpu") == 0
    finally:
        session.reset_manager(token)
        mgr.reset()
        mountinfo.set_mountpoints_for_testing(None)
    (record,) = [json.loads(line) for line in history.read_text().splitlines()]
    assert record["storage_bytes"] == cached
    assert cached["chunks"] == 4000
