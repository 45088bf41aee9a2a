"""Long-lived worker mode: builds over a unix socket, and the resident
build sessions they lease.

Reference: lib/client/ (MakisuClient {Ready, Build, Exit} over a unix
socket, client.go:36-191). Copy of ``makisu_tpu/worker/``: the client
(``client.py``, which never imports torch), the server (``server.py``,
whose builds run in its process and share S1 launches through the hash
service), the sessions (``session.py``) and their snapshot plane
(``snapshots.py``).
"""

from makisu_tpu_torch.worker.client import (
    BuildInfo,
    PercentileStats,
    WorkerBuilds,
    WorkerClient,
    WorkerHealth,
)
from makisu_tpu_torch.worker.server import WorkerServer

__all__ = ["BuildInfo", "PercentileStats", "WorkerBuilds",
           "WorkerClient", "WorkerHealth", "WorkerServer"]
