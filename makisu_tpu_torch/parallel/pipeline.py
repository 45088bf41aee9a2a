"""The sharded hash step: the multi-device form of G1 and S1.

Counterpart of ``makisu_tpu/parallel/pipeline.py``. The long-stream
dimension is sequence-parallel: Gear's hash at position i depends on at
most the 31 bytes before it (mod 2^32), so a seq shard needs only its
left neighbour's last bytes. Each rank sends the last 32 bytes of every
row to its right neighbour on the seq axis and receives its left
neighbour's (``batch_isend_irecv``, the reference's ring permutation
``i -> i + 1 mod n``), then runs one G1 launch over its shard: seq index
0 with the zero-history head (it discards what the ring's wrap brought,
the reference's zero-G mask), every other index with the halo entry.
Over gloo the 32 bytes per row cross through the host; over NCCL they
stay on the card.

Chunk-lane SHA-256 is parallel over lanes: each rank hashes its L /
world lanes with S1's lane entry, with no collective.

Each function returns a callable over this rank's local shards (cut by
``parallel/mesh.py``'s ``block_shard`` and ``lane_shard``). On CUDA
tensors the callables launch the kernels or raise; on CPU tensors they
run the plain versions, as the kernels' wrappers do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from makisu_tpu_torch.ops import gear, gear_cuda, sha256_cuda
from makisu_tpu_torch.parallel.mesh import (SEQ_AXIS, axis_sizes,
                                            coordinate)


def exchange_halo(mesh: DeviceMesh, block: torch.Tensor) -> torch.Tensor:
    """The last ``gear_cuda.HALO`` bytes of each row of the left seq
    neighbour's shard, uint8 [rows, HALO] on ``block``'s device (seq
    index 0 gets the ring's wrap, the last shard's). With one seq shard
    there is no neighbour and nothing crosses: its own tail comes back."""
    _, seq = axis_sizes(mesh)
    tail = block[:, -gear_cuda.HALO:].contiguous()
    if seq == 1:
        return tail
    group = mesh.get_group(SEQ_AXIS)
    _, s = coordinate(mesh)
    host = mesh.device_type == "cpu"
    send = tail.cpu() if host else tail
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (s + 1) % seq), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (s - 1) % seq), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(block.device)


def gear_bitmap_sharded(mesh: DeviceMesh,
                        avg_bits: int = gear.DEFAULT_AVG_BITS):
    """uint8 [B / data, N / seq] local block shard -> uint32
    [B / data, N / (32 seq)] local bitmap, halo-stitched: the shards
    gathered equal the unsharded stream's zero-history bitmap."""

    def shard(block: torch.Tensor) -> torch.Tensor:
        if block.dim() != 2:
            raise ValueError(f"a block shard is [rows, n], got "
                             f"{tuple(block.shape)}")
        if block.shape[1] % 32 or block.shape[1] < gear_cuda.HALO:
            raise ValueError(f"shard length {block.shape[1]} not a "
                             "positive multiple of 32")
        halo = exchange_halo(mesh, block)
        if coordinate(mesh)[1] == 0:
            return gear_cuda.gear_bitmap(block, avg_bits, "zero_history")
        return gear_cuda.gear_bitmap(block, avg_bits, halo=halo)

    return shard


def sha256_lanes_sharded(mesh: DeviceMesh):
    """(uint8 [L / world, CAP] local lanes, int32 [L / world] lengths)
    -> uint32 [L / world, 8] digests. On the card it waits for its
    launch and raises ValueError for a length outside [0, CAP - 9]
    (``sha256_cuda.check_lengths``)."""
    coordinate(mesh)  # a rank outside the mesh has no lanes

    def shard(lanes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        digests = sha256_cuda.sha256_lanes(lanes, lengths)
        sha256_cuda.check_lengths(lanes.device)
        return digests

    return shard


def snapshot_hash_step(mesh: DeviceMesh,
                       avg_bits: int = gear.DEFAULT_AVG_BITS):
    """The full sharded step over local shards: G1 over a block shard
    (with its halo) and S1 over a lane shard, one launch each.

    blocks:  uint8 [B / data, N / seq]   (global B % data == 0,
             N % (32 seq) == 0)
    lanes:   uint8 [L / world, CAP]      (global L % world == 0,
             CAP % 64 == 0)
    lengths: int32 [L / world]
    Returns (local bitmap uint32 [B / data, N / (32 seq)], local digests
    uint32 [L / world, 8]); ``mesh.gather_blocks`` / ``gather_lanes``
    rebuild the global results."""
    gear_fn = gear_bitmap_sharded(mesh, avg_bits)
    sha_fn = sha256_lanes_sharded(mesh)

    def step(blocks: torch.Tensor, lanes: torch.Tensor,
             lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return gear_fn(blocks), sha_fn(lanes, lengths)

    return step
