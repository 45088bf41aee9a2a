"""Build-farm front door: fleet scheduler + worker registry + peers.

Copy of ``makisu_tpu/fleet/``. N workers become a fleet:

- ``scheduler.py`` — the routing core: session affinity first,
  consistent-hash placement for new contexts, least-loaded spillover
  past a queue-depth threshold, per-tenant in-flight quotas, and
  failover when a worker is unreachable, refuses admission or dies.
- ``server.py`` — the HTTP front door. It speaks the worker's own
  protocol over a unix socket, so every client (``WorkerClient``,
  ``top``, loadgen) points at the fleet socket unchanged.
- ``slo.py`` — burn-rate rules and their evaluator (worker and front
  door), and the front door's canary builds.
- ``doctor.py`` — ``doctor --fleet``: the front door's ``/healthz`` as
  a diagnosis.
- ``peers.py`` — the peer chunk exchange the scheduler publishes the
  map for: a worker missing a chunk asks its peers before the registry.
- ``kv.py`` — a shared cache-KV endpoint for multi-worker harnesses.

The front door, its scheduler and the readers never import torch: the
builds run, and touch the card, in the workers.
"""

from makisu_tpu_torch.fleet.scheduler import FleetScheduler, WorkerSpec
from makisu_tpu_torch.fleet.server import FleetServer

__all__ = ["FleetScheduler", "FleetServer", "WorkerSpec"]
