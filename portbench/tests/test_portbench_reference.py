"""The plain reference agrees with the program's plain (``device="cpu"``)
path on small inputs, and its Gear recurrence with the sequential
definition; the control's cuts differ from it."""

import io
import os
import tarfile

import numpy as np
import pytest

from portbench import gen
from portbench.reference import gear, judge, layers

CHUNKING = {"avg_bits": 13, "min_size": 2048, "max_size": 65536}


def members(target: int, seed: int):
    out = []
    for name, content in gen.layer_files(target, seed):
        info = tarfile.TarInfo(name)
        info.size = len(content)
        info.mode = 0o644
        info.mtime = gen.CONTEXT_MTIME
        out.append((info, content))
    return out


def sequential_candidates(data: bytes, avg_bits: int) -> list[int]:
    table = gear.gear_table()
    mask = (1 << avg_bits) - 1
    h = 0
    out = []
    for i, b in enumerate(data):
        h = ((h << 1) + int(table[b])) & gear.M32
        if h & mask == 0:
            out.append(i)
    return out


def test_windowed_sum_is_the_sequential_recurrence(monkeypatch):
    data = np.random.default_rng(3).integers(0, 256, 20_000,
                                             dtype=np.uint8).tobytes()
    monkeypatch.setattr(gear, "PIECE", 4096)  # history across pieces
    for bits in (4, 8):
        got = gear.candidates(data, bits, "cpu").tolist()
        assert got == sequential_candidates(data, bits)


@pytest.mark.parametrize("backend_id", ["pgzip-1-131072", "zlib-6"])
def test_reference_agrees_with_the_programs_plain_path(backend_id):
    from makisu_tpu_torch.chunker.hasher import GPUHasher

    mem = members(160 << 10, 4294967301)
    fd = os.memfd_create("portbench-test")
    with os.fdopen(fd, "wb", buffering=0) as out:
        sink = GPUHasher(device="cpu").open_layer(out, backend_id=backend_id)
        tw = sink.open_tar()
        for info, content in mem:
            tw.addfile(info, io.BytesIO(content))
        tw.close()
        commit = sink.finish()
        blob = os.pread(fd, os.fstat(fd).st_size, 0)
    assert sink.route == "native"
    tar = layers.tar_stream(mem)
    pair = commit.digest_pair
    assert pair.tar_digest.hex() == layers.sha256_hex(tar)
    assert blob == layers.blob_for(tar, backend_id)
    assert pair.gzip_descriptor.digest.hex() == layers.sha256_hex(blob)
    chunks = [(c.offset, c.length, c.hex_digest) for c in commit.chunks]
    ends = judge.want_ends(tar, CHUNKING, "cpu")
    assert judge.chunk_counts(tar, chunks, ends) == {
        "cut_ends": 0, "chunk_digests": 0, "untiled": 0}
    control = judge.control_chunks(tar, CHUNKING, "cpu", 32 << 10)
    assert judge.chunk_counts(tar, control, ends)["cut_ends"] > 0


def test_copy_layers_follow_the_dockerfile():
    files = {"svc0/a/x.ts": b"0", "svc1/b/y.ts": b"1", "svc2/c/z": b"2",
             "Dockerfile": b"d"}
    mono = layers.copy_layers("FROM scratch\nCOPY svc0 svc1 /srv/ #!COMMIT\n"
                              "COPY svc2 /srv/ #!COMMIT\n", files)
    assert mono == [{"srv/a/x.ts": b"0", "srv/b/y.ts": b"1"},
                    {"srv/c/z": b"2"}]
    app = layers.copy_layers("FROM scratch\nCOPY . /app/\n", files)
    assert app == [{"app/" + k: v for k, v in files.items()}]
    assert layers.file_mismatches({"a": b"1", "b": b"2"},
                                  {"a": b"1", "b": b"3", "c": b""}) == 2
