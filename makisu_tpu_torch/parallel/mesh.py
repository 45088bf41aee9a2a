"""The (data, seq) device mesh of the sharded hash step.

Counterpart of ``makisu_tpu/parallel/mesh.py``. The mesh has two axes:
- ``data``: independent byte buffers / lane groups (pure data parallel);
- ``seq``: the long-stream dimension of one buffer, sharded with a
  Gear-window halo passed between neighbours (``parallel/pipeline.py``).

Each rank of a ``torch.distributed`` group is one device of the mesh:
rank ``d * seq + s`` sits at ``(d, s)``, the reference's device order
(``np.array(devices).reshape(n // seq, seq)``). The mesh is a
``DeviceMesh`` whose ``device_type`` is where its collectives run:
``cuda`` over NCCL (each rank its own card), ``cpu`` over gloo (the CPU,
or ranks sharing one card, whose halo then crosses through the host).

In place of the reference's shardings and ``jax.device_put``, plain
functions cut this rank's shard out of a global tensor and gather the
shards back into it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def mesh_shape(n: int, seq_parallel: int | None = None) -> tuple[int, int]:
    """(data, seq) for ``n`` devices. ``seq_parallel`` fixes the seq
    axis; by default it is the smallest divisor of n from floor(sqrt(n))
    up, the reference's rule: (1, 1), (2, 1), (2, 2), (4, 2) for 1, 2,
    4, 8. ValueError when n is not divisible by ``seq_parallel``."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if seq_parallel is None:
        seq_parallel = next(c for c in range(math.isqrt(n), n + 1)
                            if n % c == 0)
    if seq_parallel < 1 or n % seq_parallel:
        raise ValueError(f"{n} devices not divisible by seq={seq_parallel}")
    return n // seq_parallel, seq_parallel


def make_mesh(world: int | None = None, seq_parallel: int | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A (data, seq) mesh over ranks ``0 .. world - 1`` of the default
    process group (``world``: default its whole size; ranks past it get
    no coordinate). ``device_type`` defaults to ``cuda`` on an NCCL
    group and ``cpu`` otherwise. Every rank of the group calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_process_group, or initialize_multihost)")
    size = dist.get_world_size()
    world = size if world is None else world
    if not 1 <= world <= size:
        raise ValueError(f"a mesh of {world} ranks in a group of {size}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, mesh_shape(world, seq_parallel),
                            mesh_dim_names=(DATA_AXIS, SEQ_AXIS))


def axis_sizes(mesh: DeviceMesh) -> tuple[int, int]:
    """(data, seq) sizes of ``mesh``."""
    return mesh.size(0), mesh.size(1)


def coordinate(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's (d, s); ValueError on a rank outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return coord[0], coord[1]


def block_shard(mesh: DeviceMesh, blocks: torch.Tensor) -> torch.Tensor:
    """This rank's shard of [B, N] byte blocks (B over data, N over
    seq), contiguous: [B / data, N / seq]. ValueError where the
    reference's sharded step refuses the shape (B % data, N % (32 *
    seq))."""
    data, seq = axis_sizes(mesh)
    if blocks.dim() != 2:
        raise ValueError(f"blocks must be [B, N], got {tuple(blocks.shape)}")
    b, n = blocks.shape
    if b % data:
        raise ValueError(f"batch {b} not divisible by data={data}")
    if n % (32 * seq):
        raise ValueError(f"block length {n} not divisible by 32 * seq "
                         f"= {32 * seq}")
    d, s = coordinate(mesh)
    rows, cols = b // data, n // seq
    return blocks[d * rows:(d + 1) * rows,
                  s * cols:(s + 1) * cols].contiguous()


def lane_shard(mesh: DeviceMesh, lanes: torch.Tensor) -> torch.Tensor:
    """This rank's shard of [L, ...] lanes (or per-lane values [L]):
    lanes over every device, rank r = d * seq + s holding rows r * L /
    world onwards. ValueError when L % world."""
    data, seq = axis_sizes(mesh)
    world = data * seq
    n = lanes.shape[0]
    if n % world:
        raise ValueError(f"{n} lanes not divisible by the mesh's {world} "
                         "devices")
    d, s = coordinate(mesh)
    per = n // world
    r = d * seq + s
    return lanes[r * per:(r + 1) * per].contiguous()


def _all_gather(local: torch.Tensor, group, dim: int,
                host: bool) -> torch.Tensor:
    """Concatenation along ``dim`` of every group rank's ``local`` (same
    shapes), in group-rank order. Crosses as int32 or uint8 words (NCCL
    has no uint32), through the host where ``host``."""
    wire = local.contiguous()
    if wire.dtype == torch.uint32:
        wire = wire.view(torch.int32)
    if host:
        wire = wire.cpu()
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=dim).to(local.device)
    return out.view(local.dtype) if out.dtype != local.dtype else out


def gather_blocks(mesh: DeviceMesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's [B / data, W / seq] shard of a block-sharded result
    back into the global [B, W], on every rank of the mesh (the inverse
    of ``block_shard``, for the bitmaps)."""
    host = mesh.device_type == "cpu"
    rows = _all_gather(local, mesh.get_group(SEQ_AXIS), 1, host)
    return _all_gather(rows, mesh.get_group(DATA_AXIS), 0, host)


def gather_lanes(mesh: DeviceMesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's lane shard back into the global [L, ...] on every
    rank of the mesh (the inverse of ``lane_shard``, for the digests)."""
    host = mesh.device_type == "cpu"
    seq_major = _all_gather(local, mesh.get_group(SEQ_AXIS), 0, host)
    return _all_gather(seq_major, mesh.get_group(DATA_AXIS), 0, host)
