"""The frozen generators: the same seed gives the same bytes."""

import hashlib

from portbench import gen


def digest(pairs) -> str:
    h = hashlib.sha256()
    for name, content in pairs:
        h.update(name.encode() + b"\0" + content)
    return h.hexdigest()


def test_layer_files_are_a_function_of_the_seed():
    a = list(gen.layer_files(6 << 20, 4294967301))
    b = list(gen.layer_files(6 << 20, 4294967301))
    c = list(gen.layer_files(6 << 20, 4294967302))
    assert digest(a) == digest(b) != digest(c)
    assert a[0][0].startswith("app/node_modules/")
    assert any(name.startswith("app/bin/") for name, _ in a)
    tar_bytes = sum(512 + -(-len(x) // 512) * 512 for _, x in a)
    assert 6 << 20 <= tar_bytes < (6 << 20) + (16 << 20)


def test_dist_files_are_a_function_of_the_seed():
    a = list(gen.dist_files(2 << 20, 31, 8))
    assert digest(a) == digest(gen.dist_files(2 << 20, 31, 8))
    assert digest(a) != digest(gen.dist_files(2 << 20, 32, 8))
    assert {name.split("/")[0] for name, _ in a} == {f"svc{k}"
                                                     for k in range(8)}
    assert sum(len(x) for _, x in a) >= 2 << 20


def test_dist_dockerfile_has_four_committed_copies():
    text = gen.dist_dockerfile(8)
    assert text.splitlines()[0] == "FROM scratch"
    assert text.count("#!COMMIT") == 4
    assert "COPY svc6 svc7 /srv/ #!COMMIT" in text


def test_one_percent_edit_is_a_function_of_seed_and_iteration(tmp_path):
    for k in range(250):
        (tmp_path / f"f{k:03d}").write_bytes(b"x")
    (tmp_path / "Dockerfile").write_text("FROM scratch\n")
    first = gen.append_to_one_percent(str(tmp_path), [5, 1])
    assert len(first) == 2 and "Dockerfile" not in first
    paths = sorted(f"f{k:03d}" for k in range(250))
    assert gen.pick_one_percent(paths, [5, 1]) == first
    assert gen.pick_one_percent(paths, [5, 2]) != first
    for rel in first:
        assert (tmp_path / rel).read_bytes() == b"x" + gen.EDIT_BYTES


def test_write_context_dates_every_file(tmp_path):
    files = list(gen.dist_files(400 << 10, 3, 8))
    n, nbytes = gen.write_context(str(tmp_path), files, "FROM scratch\n")
    assert n == len(files) and nbytes == sum(len(x) for _, x in files)
    for path in tmp_path.rglob("*"):
        assert int(path.stat().st_mtime) == gen.CONTEXT_MTIME


def test_every_seed_deals_the_same_files_among_the_paths():
    cfg = {"generator": "dist_files", "context_bytes": 4 << 20,
           "services": 8, "shape_seed": 31}
    a = gen.context_files(cfg, 1)
    b = gen.context_files(cfg, 2)
    assert [p for p, _ in a] == [p for p, _ in b]
    assert a != b and a == gen.context_files(cfg, 1)
    for files in (a, b):
        by_group = {}
        for path, content in files:
            by_group.setdefault(gen._group(path), []).append(content)
        want = {}
        for path, content in gen.dist_files(4 << 20, 31, 8):
            want.setdefault(gen._group(path), []).append(content)
        assert {k: sorted(v) for k, v in by_group.items()} == \
            {k: sorted(v) for k, v in want.items()}
