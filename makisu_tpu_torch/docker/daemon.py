"""Minimal docker daemon client over the unix socket (for --load).

Copy of ``makisu_tpu/docker/daemon.py``.

Reference: lib/docker/cli/cli.go (DockerClient :37-81, ImageTarLoad POST
/images/load :83).
"""

from __future__ import annotations

import http.client
import socket


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 600.0) -> None:
        super().__init__("localhost", timeout=timeout)
        self.socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self.socket_path)
        self.sock = sock


class DockerClient:
    def __init__(self, host: str = "unix:///var/run/docker.sock",
                 version: str = "1.21", scheme: str = "http") -> None:
        if not host.startswith("unix://"):
            raise ValueError(f"only unix:// docker hosts supported: {host}")
        self.socket_path = host[len("unix://"):]
        self.version = version

    # A multi-GB image load into a busy daemon is legitimately slow;
    # the bound exists so a hung dockerd fails the build instead of
    # wedging it (the `check` unbounded-io invariant).
    LOAD_TIMEOUT = 600.0

    def image_tar_load(self, tar_path: str) -> None:
        conn = _UnixHTTPConnection(self.socket_path,
                                   timeout=self.LOAD_TIMEOUT)
        try:
            with open(tar_path, "rb") as f:
                conn.request(
                    "POST", f"/v{self.version}/images/load",
                    body=f, headers={"Content-Type": "application/x-tar"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status // 100 != 2:
                raise RuntimeError(
                    f"docker load failed ({resp.status}): {body[:300]!r}")
        finally:
            conn.close()
