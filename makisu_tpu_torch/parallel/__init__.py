"""Multi-device parallelism for the hashing pipeline (mesh, shard cuts
and the halo-stitched step on G1 and S1)."""

from makisu_tpu_torch.parallel.distributed import initialize_multihost
from makisu_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    block_shard,
    gather_blocks,
    gather_lanes,
    lane_shard,
    make_mesh,
    mesh_shape,
)
from makisu_tpu_torch.parallel.pipeline import (
    gear_bitmap_sharded,
    sha256_lanes_sharded,
    snapshot_hash_step,
)

__all__ = [
    "DATA_AXIS", "SEQ_AXIS", "block_shard", "gather_blocks",
    "gather_lanes", "lane_shard", "make_mesh", "mesh_shape",
    "initialize_multihost",
    "gear_bitmap_sharded", "sha256_lanes_sharded", "snapshot_hash_step",
]
