"""The image data model the layer commit needs: digests and descriptors.

Copies of ``makisu_tpu/docker/image.py``'s ``MEDIA_TYPE_LAYER``,
``Digest``, ``Descriptor`` and ``DigestPair``, with only the methods the
layer commit calls; wire formats follow the Docker registry v2 /
image-spec standards.
"""

from __future__ import annotations

import dataclasses

SHA256 = "sha256"
MEDIA_TYPE_LAYER = "application/vnd.docker.image.rootfs.diff.tar.gzip"


class Digest(str):
    """A content digest string of the form ``sha256:<64 hex>``."""

    def hex(self) -> str:
        return self.split(":", 1)[1]

    @staticmethod
    def from_hex(hexstr: str) -> "Digest":
        return Digest(SHA256 + ":" + hexstr)


@dataclasses.dataclass(frozen=True)
class Descriptor:
    media_type: str
    size: int
    digest: Digest


@dataclasses.dataclass(frozen=True)
class DigestPair:
    """Identity of one committed layer: digest of the uncompressed tar
    (the diffID) + descriptor of the compressed blob (what registries
    address)."""

    tar_digest: Digest
    gzip_descriptor: Descriptor
