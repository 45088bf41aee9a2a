"""The port's GPUHasher on the CPU held against the JAX package's
TPUHasher through its Python sink: identical LayerCommit (digest pair,
chunk list, backend id) and identical gzip blob bytes."""

import gzip
import hashlib
import io
import tarfile

import numpy as np
import pytest
import torch

from makisu_tpu.chunker import TPUHasher
from makisu_tpu_torch.chunker import GPUHasher, LayerSink, get_hasher


def layer_tar(seed=3, nfiles=24):
    """A small deterministic layer tar: text-like files, a binary, and
    a repeated file."""
    rng = np.random.default_rng(seed)
    out = io.BytesIO()
    with tarfile.open(fileobj=out, mode="w", format=tarfile.PAX_FORMAT) as tf:
        for k in range(nfiles):
            if k % 7 == 6:
                body = b"repeated file contents\n" * 300
            elif k % 5 == 4:
                body = rng.integers(0, 256, size=int(rng.integers(1, 30_000)),
                                    dtype=np.uint8).tobytes()
            else:
                words = rng.integers(0, 50, size=int(rng.integers(10, 4000)))
                body = b" ".join(b"w%d" % w for w in words)
            info = tarfile.TarInfo(f"app/node_modules/p{k // 5}/f{k}.js")
            info.size = len(body)
            tf.addfile(info, io.BytesIO(body))
    return out.getvalue()


def commit_with(hasher, payload, backend_id, step=7777):
    out = io.BytesIO()
    sink = hasher.open_layer(out, backend_id=backend_id)
    for i in range(0, len(payload), step):
        sink.write(payload[i:i + step])
    return sink.finish(), out.getvalue()


@pytest.mark.parametrize("backend_id", ["zlib-6", "zlib-0"])
def test_layer_commit_matches_reference(monkeypatch, backend_id):
    monkeypatch.setenv("MAKISU_TPU_CHUNK_NATIVE", "0")
    payload = layer_tar()
    got, blob = commit_with(GPUHasher(device="cpu"), payload, backend_id)
    want, want_blob = commit_with(TPUHasher(), payload, backend_id)
    assert blob == want_blob
    gp, wp = got.digest_pair, want.digest_pair
    assert gp.tar_digest == wp.tar_digest
    assert gp.tar_digest.hex() == hashlib.sha256(payload).hexdigest()
    assert (gp.gzip_descriptor.media_type, gp.gzip_descriptor.size,
            gp.gzip_descriptor.digest) == (
        wp.gzip_descriptor.media_type, wp.gzip_descriptor.size,
        wp.gzip_descriptor.digest)
    assert [(c.offset, c.length, c.hex_digest) for c in got.chunks] == \
        [(c.offset, c.length, c.hex_digest) for c in want.chunks]
    assert got.chunk_ids == want.chunk_ids and len(got.chunks) > 3
    assert got.gzip_backend_id == want.gzip_backend_id == backend_id
    assert gzip.decompress(blob) == payload


def test_level0_blob_independent_of_write_size():
    payload = layer_tar(seed=4, nfiles=8)
    a = commit_with(GPUHasher(device="cpu"), payload, "zlib-0", 1000)
    b = commit_with(GPUHasher(device="cpu"), payload, "zlib-0", 100_000)
    assert a[1] == b[1] and a[0].digest_pair == b[0].digest_pair


@pytest.mark.parametrize("threaded", [True, False])
def test_plain_sink_threaded_and_inline_agree(monkeypatch, threaded):
    # The sink compresses on a worker thread on a multicore host only.
    monkeypatch.setattr("os.cpu_count", lambda: 8 if threaded else 1)
    payload = layer_tar(seed=5, nfiles=6)
    out = io.BytesIO()
    sink = LayerSink(out)
    assert (sink._worker is not None) == threaded
    for i in range(0, len(payload), 4096):
        sink.write(payload[i:i + 4096])
    commit = sink.finish()
    assert commit.chunks == [] and commit.gzip_backend_id == "zlib-6"
    assert commit.digest_pair.gzip_descriptor.digest.hex() == \
        hashlib.sha256(out.getvalue()).hexdigest()
    assert gzip.decompress(out.getvalue()) == payload
    with pytest.raises(RuntimeError):
        sink.finish()


def test_get_hasher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    hasher = get_hasher("gpu")
    assert hasher.name == "gpu" and hasher.device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_hasher("gpu")
    with pytest.raises(ValueError):
        get_hasher("tpu")


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        GPUHasher(device="cpu").open_layer(io.BytesIO(),
                                           backend_id="pgzip-6-131072")
