"""docker-save tarball assembly and import (``build --dest``/``--load``,
``push``).

Copy of ``makisu_tpu/docker/save.py`` (reference: lib/docker/cli/image.go
DefaultImageTarer:33-137 — a docker-save layout: manifest.json + config
json + layer dirs with layer.tar; bin/makisu/cmd/push.go importTar:159).
"""

from __future__ import annotations

import gzip
import io
import json
import tarfile

from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_CONFIG,
    MEDIA_TYPE_LAYER,
    Descriptor,
    Digest,
    DistributionManifest,
    ImageName,
)
from makisu_tpu_torch.storage import ImageStore


def write_save_tar(store: ImageStore, name: ImageName, out_path: str) -> None:
    """Write a ``docker load``-able tar for an image in the store.

    Layers are stored gzipped (registry format) but docker-save layout
    wants plain tars, so each layer is decompressed on the way through.
    """
    manifest = store.manifests.load(name)
    config_name = manifest.config.digest.hex() + ".json"
    with open(store.layers.path(manifest.config.digest.hex()), "rb") as f:
        config_blob = f.read()

    with tarfile.open(out_path, "w") as tw:
        def add_bytes(arcname: str, data: bytes) -> None:
            ti = tarfile.TarInfo(arcname)
            ti.size = len(data)
            tw.addfile(ti, io.BytesIO(data))

        add_bytes(config_name, config_blob)
        layer_paths = []
        for desc in manifest.layers:
            arcdir = desc.digest.hex()
            with open(store.layers.path(desc.digest.hex()), "rb") as f:
                tar_bytes = gzip.decompress(f.read())
            add_bytes(f"{arcdir}/layer.tar", tar_bytes)
            layer_paths.append(f"{arcdir}/layer.tar")
        export = [{
            "Config": config_name,
            "RepoTags": [f"{name.repository}:{name.tag}"],
            "Layers": layer_paths,
        }]
        add_bytes("manifest.json",
                  json.dumps(export, separators=(",", ":")).encode())


def load_save_tar(store: ImageStore, tar_path: str,
                  name: ImageName) -> DistributionManifest:
    """Import a docker-save tar into the store under ``name``: each layer
    tar is gzipped (mtime 0, level 9 as ``gzip.compress``) into a blob."""
    with tarfile.open(tar_path, "r") as tf:
        members = {m.name: m for m in tf.getmembers()}
        export = json.load(tf.extractfile(members["manifest.json"]))
        entry = export[0]
        config_blob = tf.extractfile(members[entry["Config"]]).read()
        config_digest = Digest.of_bytes(config_blob)
        store.layers.write_bytes(config_digest.hex(), config_blob)
        layers = []
        for layer_name in entry["Layers"]:
            tar_bytes = tf.extractfile(members[layer_name]).read()
            blob = gzip.compress(tar_bytes, mtime=0)
            digest = Digest.of_bytes(blob)
            store.layers.write_bytes(digest.hex(), blob)
            layers.append(Descriptor(MEDIA_TYPE_LAYER, len(blob), digest))
    manifest = DistributionManifest(
        config=Descriptor(MEDIA_TYPE_CONFIG, len(config_blob),
                          config_digest),
        layers=layers)
    store.manifests.save(name, manifest)
    return manifest
