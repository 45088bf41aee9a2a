"""Docker image data model: names, digests, configs, manifests.

Copy of ``makisu_tpu/docker/image.py``. Pure data layer (reference:
lib/docker/image/ — image_name.go:102-183, image_config.go:25-115,
distribution_manifest.go:35-70). Wire formats are fixed by the Docker
registry v2 / image-spec standards, so JSON field names here follow
those specs exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Any

SHA256 = "sha256"
SCRATCH = "scratch"
DOCKERHUB_REGISTRY = "index.docker.io"
DOCKERHUB_NAMESPACE = "library"

MEDIA_TYPE_MANIFEST = "application/vnd.docker.distribution.manifest.v2+json"
MEDIA_TYPE_CONFIG = "application/vnd.docker.container.image.v1+json"
MEDIA_TYPE_LAYER = "application/vnd.docker.image.rootfs.diff.tar.gzip"

# OCI image-spec equivalents: accepted on pull; pushes use docker types.
MEDIA_TYPE_OCI_MANIFEST = "application/vnd.oci.image.manifest.v1+json"
MEDIA_TYPE_OCI_CONFIG = "application/vnd.oci.image.config.v1+json"
MEDIA_TYPE_OCI_LAYER = "application/vnd.oci.image.layer.v1.tar+gzip"
# zstd layers: accepted on pull when libzstd decodes them (utils/zstdio),
# stored and pushed verbatim; layers this builder writes stay gzip.
MEDIA_TYPE_OCI_LAYER_ZSTD = "application/vnd.oci.image.layer.v1.tar+zstd"
MEDIA_TYPE_LAYER_ZSTD = "application/vnd.docker.image.rootfs.diff.tar.zstd"
# Multi-arch fan-out documents, resolved to one platform on pull.
MEDIA_TYPE_MANIFEST_LIST = \
    "application/vnd.docker.distribution.manifest.list.v2+json"
MEDIA_TYPE_OCI_INDEX = "application/vnd.oci.image.index.v1+json"

_HOSTNAME_RE = re.compile(r"^([\w\d.-]+(?:\.[\w\d.-]+|:\d+))/")


class Digest(str):
    """A content digest string of the form ``sha256:<64 hex>``."""

    def hex(self) -> str:
        return self.split(":", 1)[1]

    @staticmethod
    def of_bytes(data: bytes) -> "Digest":
        return Digest(SHA256 + ":" + hashlib.sha256(data).hexdigest())

    @staticmethod
    def from_hex(hexstr: str) -> "Digest":
        return Digest(SHA256 + ":" + hexstr)


@dataclasses.dataclass(frozen=True)
class ImageName:
    """Parsed image name <registry>/<repository>:<tag>.

    Parsing semantics match the reference (image_name.go:102-183): the tag
    separator only counts after the last '/', an '@' introduces a digest
    used in place of the tag, and a leading component is the registry only
    if it contains a '.' or ':port'.
    """

    registry: str = ""
    repository: str = ""
    tag: str = "latest"

    @staticmethod
    def parse(s: str) -> "ImageName":
        registry, repository, tag = "", s, "latest"
        slash = s.rfind("/")
        sep = s.rfind(":")
        at = s.rfind("@")
        if sep < slash or sep == -1:
            repository, tag = s, "latest"
        elif slash < at < sep:
            repository = s[:at]
            sep2 = repository.rfind(":")
            if sep2 != -1 and sep2 >= slash:
                repository = repository[:sep2]
            tag = s[at + 1:]  # digest takes the tag slot for pull-by-digest
        else:
            repository, tag = s[:sep], s[sep + 1:]
        m = _HOSTNAME_RE.match(repository)
        if m:
            registry = m.group(1)
            repository = repository[len(registry) + 1:]
        return ImageName(registry, repository, tag)

    @staticmethod
    def parse_for_pull(s: str) -> "ImageName":
        """Like parse, with dockerhub registry/namespace defaulting."""
        name = ImageName.parse(s)
        if name.repository == SCRATCH:
            return name
        if not name.registry:
            repo = name.repository
            if "/" not in repo:
                repo = DOCKERHUB_NAMESPACE + "/" + repo
            return ImageName(DOCKERHUB_REGISTRY, repo, name.tag)
        return name

    def with_registry(self, registry: str) -> "ImageName":
        return ImageName(registry, self.repository, self.tag)

    @property
    def is_scratch(self) -> bool:
        return self.repository == SCRATCH

    def short_name(self) -> str:
        sep = "@" if self.tag.startswith(SHA256 + ":") else ":"
        return f"{self.repository}{sep}{self.tag}"

    def __str__(self) -> str:
        if self.is_scratch:
            return self.short_name()
        if self.registry:
            return f"{self.registry}/{self.short_name()}"
        return self.short_name()


def _drop_nones(d: dict[str, Any]) -> dict[str, Any]:
    return {k: v for k, v in d.items() if v is not None}


@dataclasses.dataclass
class HealthConfig:
    """HEALTHCHECK settings (docker image-spec)."""

    test: list[str] = dataclasses.field(default_factory=list)
    interval: int = 0   # nanoseconds, docker convention
    timeout: int = 0
    start_period: int = 0
    retries: int = 0

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"Test": self.test}
        if self.interval:
            out["Interval"] = self.interval
        if self.timeout:
            out["Timeout"] = self.timeout
        if self.start_period:
            out["StartPeriod"] = self.start_period
        if self.retries:
            out["Retries"] = self.retries
        return out

    @staticmethod
    def from_json(d: dict[str, Any]) -> "HealthConfig":
        return HealthConfig(
            test=d.get("Test") or [],
            interval=d.get("Interval", 0),
            timeout=d.get("Timeout", 0),
            start_period=d.get("StartPeriod", 0),
            retries=d.get("Retries", 0),
        )


@dataclasses.dataclass
class ContainerConfig:
    """Runtime config embedded in the image config ("Config" block)."""

    user: str = ""
    exposed_ports: dict[str, dict] | None = None
    env: list[str] = dataclasses.field(default_factory=list)
    entrypoint: list[str] | None = None
    cmd: list[str] | None = None
    volumes: dict[str, dict] | None = None
    working_dir: str = ""
    labels: dict[str, str] | None = None
    stop_signal: str = ""
    healthcheck: HealthConfig | None = None
    on_build: list[str] | None = None
    image: str = ""

    def to_json(self) -> dict[str, Any]:
        return _drop_nones({
            "User": self.user,
            "ExposedPorts": self.exposed_ports,
            "Env": self.env or [],
            "Entrypoint": self.entrypoint,
            "Cmd": self.cmd,
            "Volumes": self.volumes,
            "WorkingDir": self.working_dir,
            "Labels": self.labels,
            "StopSignal": self.stop_signal or None,
            "Healthcheck": self.healthcheck.to_json() if self.healthcheck else None,
            "OnBuild": self.on_build,
            "Image": self.image or None,
        })

    @staticmethod
    def from_json(d: dict[str, Any] | None) -> "ContainerConfig":
        d = d or {}
        hc = d.get("Healthcheck")
        return ContainerConfig(
            user=d.get("User") or "",
            exposed_ports=d.get("ExposedPorts"),
            env=d.get("Env") or [],
            entrypoint=d.get("Entrypoint"),
            cmd=d.get("Cmd"),
            volumes=d.get("Volumes"),
            working_dir=d.get("WorkingDir") or "",
            labels=d.get("Labels"),
            stop_signal=d.get("StopSignal") or "",
            healthcheck=HealthConfig.from_json(hc) if hc else None,
            on_build=d.get("OnBuild"),
            image=d.get("Image") or "",
        )


@dataclasses.dataclass
class History:
    created: str = ""
    created_by: str = ""
    author: str = ""
    comment: str = ""
    empty_layer: bool = False

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.created:
            out["created"] = self.created
        if self.created_by:
            out["created_by"] = self.created_by
        if self.author:
            out["author"] = self.author
        if self.comment:
            out["comment"] = self.comment
        if self.empty_layer:
            out["empty_layer"] = True
        return out

    @staticmethod
    def from_json(d: dict[str, Any]) -> "History":
        return History(
            created=d.get("created", ""),
            created_by=d.get("created_by", ""),
            author=d.get("author", ""),
            comment=d.get("comment", ""),
            empty_layer=d.get("empty_layer", False),
        )


@dataclasses.dataclass
class RootFS:
    type: str = "layers"
    diff_ids: list[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict[str, Any]:
        return {"type": self.type, "diff_ids": list(self.diff_ids)}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "RootFS":
        return RootFS(type=d.get("type", "layers"),
                      diff_ids=list(d.get("diff_ids") or []))


@dataclasses.dataclass
class ImageConfig:
    """The image config JSON blob (docker image-spec v1)."""

    architecture: str = "amd64"
    os: str = "linux"
    created: str = "1970-01-01T00:00:00Z"
    config: ContainerConfig = dataclasses.field(default_factory=ContainerConfig)
    container_config: ContainerConfig | None = None
    docker_version: str = ""
    author: str = ""
    history: list[History] = dataclasses.field(default_factory=list)
    rootfs: RootFS = dataclasses.field(default_factory=RootFS)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "architecture": self.architecture,
            "os": self.os,
            "created": self.created,
            "config": self.config.to_json(),
            "rootfs": self.rootfs.to_json(),
        }
        if self.container_config is not None:
            out["container_config"] = self.container_config.to_json()
        if self.docker_version:
            out["docker_version"] = self.docker_version
        if self.author:
            out["author"] = self.author
        if self.history:
            out["history"] = [h.to_json() for h in self.history]
        return out

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json(), separators=(",", ":"),
                          sort_keys=True).encode()

    @staticmethod
    def from_json(d: dict[str, Any]) -> "ImageConfig":
        cc = d.get("container_config")
        return ImageConfig(
            architecture=d.get("architecture", "amd64"),
            os=d.get("os", "linux"),
            created=d.get("created", ""),
            config=ContainerConfig.from_json(d.get("config")),
            container_config=ContainerConfig.from_json(cc) if cc else None,
            docker_version=d.get("docker_version", ""),
            author=d.get("author", ""),
            history=[History.from_json(h) for h in d.get("history") or []],
            rootfs=RootFS.from_json(d.get("rootfs") or {}),
        )

    @staticmethod
    def from_bytes(data: bytes) -> "ImageConfig":
        return ImageConfig.from_json(json.loads(data))

    def clone(self) -> "ImageConfig":
        return ImageConfig.from_json(json.loads(self.to_bytes()))


@dataclasses.dataclass(frozen=True)
class Descriptor:
    media_type: str
    size: int
    digest: Digest

    def to_json(self) -> dict[str, Any]:
        return {"mediaType": self.media_type, "size": self.size,
                "digest": str(self.digest)}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Descriptor":
        return Descriptor(d["mediaType"], d["size"], Digest(d["digest"]))


@dataclasses.dataclass(frozen=True)
class DigestPair:
    """Identity of one committed layer: digest of the uncompressed tar
    (the diffID) + descriptor of the compressed blob (what registries
    address). Reference: distribution_manifest.go DigestPair."""

    tar_digest: Digest
    gzip_descriptor: Descriptor


@dataclasses.dataclass
class DistributionManifest:
    """Registry v2 schema2 manifest."""

    schema_version: int = 2
    media_type: str = MEDIA_TYPE_MANIFEST
    config: Descriptor | None = None
    layers: list[Descriptor] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict[str, Any]:
        return {
            "schemaVersion": self.schema_version,
            "mediaType": self.media_type,
            "config": self.config.to_json() if self.config else None,
            "layers": [l.to_json() for l in self.layers],
        }

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json(), separators=(",", ":"),
                          sort_keys=True).encode()

    @staticmethod
    def from_json(d: dict[str, Any]) -> "DistributionManifest":
        return DistributionManifest(
            schema_version=d.get("schemaVersion", 2),
            media_type=d.get("mediaType", MEDIA_TYPE_MANIFEST),
            config=Descriptor.from_json(d["config"]) if d.get("config") else None,
            layers=[Descriptor.from_json(l) for l in d.get("layers") or []],
        )

    def digest(self) -> Digest:
        return Digest.of_bytes(self.to_bytes())

    def layer_digests(self) -> list[Digest]:
        return [l.digest for l in self.layers]
