"""docker-save tarball assembly (for ``build --dest``).

Copy of ``makisu_tpu/docker/save.py``'s ``write_save_tar`` (reference:
lib/docker/cli/image.go DefaultImageTarer:33-137 — a docker-save layout:
manifest.json + config json + layer dirs with layer.tar).
"""

from __future__ import annotations

import gzip
import io
import json
import tarfile

from makisu_tpu_torch.docker.image import ImageName
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
