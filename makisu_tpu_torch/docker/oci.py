"""OCI image-layout export (opencontainers image-spec v1.0).

Copy of ``makisu_tpu/docker/oci.py``.

A capability the reference lacks entirely — its only exports are
docker-save tars and registry pushes (lib/docker/cli/image.go:33-137,
bin/makisu/cmd/build.go:218-302). An OCI layout is what podman, skopeo,
and containerd consume directly (`skopeo copy oci:DIR ...`,
`podman load` accepts oci-archive tars), so builders in daemonless
environments can hand images to modern runtimes without a registry
round trip.

Layout written (image-spec/image-layout.md):

    oci-layout                 {"imageLayoutVersion": "1.0.0"}
    index.json                 one manifest descriptor, tagged via the
                               org.opencontainers.image.ref.name
                               annotation
    blobs/sha256/<hex>         config JSON, gzip layer blobs, manifest

The registry-v2 schema2 manifest maps 1:1: config and layer blobs are
byte-identical (digests unchanged); only media types change
(docker manifest.v2 -> oci manifest.v1, container.image.v1+json ->
image.config.v1+json, .tar.gzip -> .tar+gzip), so the OCI manifest is a
re-serialization with a new digest and everything below it is shared
bytes. A ``.tar`` destination writes the same layout as a DETERMINISTIC
tar (sorted names, zeroed times, uid/gid 0) — byte-identical output for
identical image content, consistent with the repo's determinism
discipline (gzip/cache identity).
"""

from __future__ import annotations

import io
import json
import os
import tarfile

from makisu_tpu_torch.docker.image import (
    MEDIA_TYPE_CONFIG,
    MEDIA_TYPE_LAYER,
    MEDIA_TYPE_MANIFEST,
    MEDIA_TYPE_OCI_CONFIG,
    MEDIA_TYPE_OCI_LAYER,
    MEDIA_TYPE_OCI_MANIFEST,
    Digest,
    ImageName,
)
from makisu_tpu_torch.storage import ImageStore

_MEDIA_MAP = {
    MEDIA_TYPE_MANIFEST: MEDIA_TYPE_OCI_MANIFEST,
    MEDIA_TYPE_CONFIG: MEDIA_TYPE_OCI_CONFIG,
    MEDIA_TYPE_LAYER: MEDIA_TYPE_OCI_LAYER,
}


def _oci_media_type(docker_type: str) -> str:
    # Already-OCI types (e.g. an image pulled from an OCI registry)
    # pass through unchanged.
    return _MEDIA_MAP.get(docker_type, docker_type)


def build_oci_manifest(manifest) -> bytes:
    """Registry schema2 manifest -> canonical OCI manifest JSON bytes."""
    doc = {
        "schemaVersion": 2,
        "mediaType": MEDIA_TYPE_OCI_MANIFEST,
        "config": {
            "mediaType": _oci_media_type(manifest.config.media_type),
            "size": manifest.config.size,
            "digest": str(manifest.config.digest),
        },
        "layers": [{
            "mediaType": _oci_media_type(layer.media_type),
            "size": layer.size,
            "digest": str(layer.digest),
        } for layer in manifest.layers],
    }
    return json.dumps(doc, separators=(",", ":"), sort_keys=True).encode()


def build_index(manifest_bytes: bytes, name: ImageName) -> bytes:
    doc = {
        "schemaVersion": 2,
        "manifests": [{
            "mediaType": MEDIA_TYPE_OCI_MANIFEST,
            "size": len(manifest_bytes),
            "digest": str(Digest.of_bytes(manifest_bytes)),
            "annotations": {
                "org.opencontainers.image.ref.name":
                    f"{name.repository}:{name.tag}",
            },
        }],
    }
    return json.dumps(doc, separators=(",", ":"), sort_keys=True).encode()


def write_oci_layout(store: ImageStore, name: ImageName,
                     dest: str) -> Digest:
    """Export an image from the store as an OCI image layout.

    ``dest`` ending in ``.tar`` writes the layout as one deterministic
    tar (oci-archive); anything else is created/filled as a directory.
    Returns the OCI manifest digest.
    """
    manifest = store.manifests.load(name)
    manifest_bytes = build_oci_manifest(manifest)
    manifest_digest = Digest.of_bytes(manifest_bytes)
    index_bytes = build_index(manifest_bytes, name)
    layout_bytes = json.dumps({"imageLayoutVersion": "1.0.0"},
                              separators=(",", ":")).encode()

    # blob name -> bytes, or None = sourced from the store CAS by name
    blobs: list[tuple[str, bytes | None]] = [
        (manifest_digest.hex(), manifest_bytes),
        (manifest.config.digest.hex(), None),
    ]
    seen = {manifest.config.digest.hex()}
    for layer in manifest.layers:
        if layer.digest.hex() not in seen:
            seen.add(layer.digest.hex())
            blobs.append((layer.digest.hex(), None))

    if dest.endswith(".tar"):
        _write_tar(dest, store, layout_bytes, index_bytes, blobs)
    else:
        _write_dir(dest, store, layout_bytes, index_bytes, blobs)
    return manifest_digest


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _write_dir(dest: str, store: ImageStore, layout: bytes, index: bytes,
               blobs: list[tuple[str, bytes | None]]) -> None:
    blob_dir = os.path.join(dest, "blobs", "sha256")
    os.makedirs(blob_dir, exist_ok=True)
    _write_atomic(os.path.join(dest, "oci-layout"), layout)
    _write_atomic(os.path.join(dest, "index.json"), index)
    for hexname, data in blobs:
        path = os.path.join(blob_dir, hexname)
        if data is not None:
            _write_atomic(path, data)
        else:
            # CAS link-or-copy; always replaces, so a previous
            # interrupted export can never leave a stale truncated blob
            # behind (link_out unlinks first).
            store.layers.link_out(hexname, path)


def _write_tar(dest: str, store: ImageStore, layout: bytes, index: bytes,
               blobs: list[tuple[str, bytes | None]]) -> None:
    # GNU format: member sizes beyond USTAR's 8 GiB cap (large layers
    # are this project's stated use case) while staying deterministic
    # with zeroed times/owners.
    def add(tw: tarfile.TarFile, arcname: str, data: bytes) -> None:
        ti = tarfile.TarInfo(arcname)  # mtime 0, uid/gid 0
        ti.size = len(data)
        ti.mode = 0o644
        tw.addfile(ti, io.BytesIO(data))

    with tarfile.open(dest, "w", format=tarfile.GNU_FORMAT) as tw:
        add(tw, "oci-layout", layout)
        add(tw, "index.json", index)
        for hexname, data in sorted(blobs, key=lambda b: b[0]):
            if data is not None:
                add(tw, f"blobs/sha256/{hexname}", data)
                continue
            # Stream straight from the CAS: constant memory for
            # multi-GiB layer blobs.
            path = store.layers.path(hexname)
            ti = tarfile.TarInfo(f"blobs/sha256/{hexname}")
            ti.size = os.stat(path).st_size
            ti.mode = 0o644
            with open(path, "rb") as f:
                tw.addfile(ti, f)
