"""Multi-process initialisation for the hashing mesh.

Counterpart of ``makisu_tpu/parallel/distributed.py``. A single process
needs nothing; across processes (and hosts), ``torch.distributed``
joins them into one group and the same (data, seq) mesh of
``parallel/mesh.py`` spans every rank. Nothing tells a process of a
cluster, so it reads the reference's three variables (k8s-friendly):

  MAKISU_TPU_COORDINATOR   host:port of process 0 (its TCP store)
  MAKISU_TPU_NUM_PROCESSES total process count
  MAKISU_TPU_PROCESS_ID    this process's index (its rank)

The backend is the caller's choice, never a retry: ``nccl`` when each
rank has a card of its own, ``gloo`` on the CPU or when ranks share one
card (NCCL refuses two ranks on one device). ``MAKISU_TPU_DIST_BACKEND``
sets it where the caller passes none.
"""

from __future__ import annotations

import os

import torch.distributed as dist

from makisu_tpu_torch.utils import logging as log

BACKENDS = ("nccl", "gloo")


def initialize_multihost(backend: str | None = None) -> bool:
    """Join the process group the environment describes; True once this
    process is in one, False without ``MAKISU_TPU_COORDINATOR`` (a
    single process: nothing to do). ``backend``: ``nccl`` or ``gloo``
    (default ``MAKISU_TPU_DIST_BACKEND``, else ``nccl``)."""
    if dist.is_initialized():
        return True
    coordinator = os.environ.get("MAKISU_TPU_COORDINATOR", "")
    if not coordinator:
        return False
    backend = backend or os.environ.get("MAKISU_TPU_DIST_BACKEND", "nccl")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=int(os.environ["MAKISU_TPU_NUM_PROCESSES"]),
        rank=int(os.environ["MAKISU_TPU_PROCESS_ID"]))
    log.info("joined distributed mesh",
             process=os.environ["MAKISU_TPU_PROCESS_ID"],
             processes=os.environ["MAKISU_TPU_NUM_PROCESSES"],
             backend=backend)
    return True
