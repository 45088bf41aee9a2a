"""Snapshot engine: in-memory merged FS, layer diffing, whiteouts.

Copy of ``makisu_tpu/snapshot/`` (reference capability: lib/snapshot/ —
MemFS mem_fs.go:59-88, CopyOperation copy_op.go:29-80,
walk/evalSymlinks utils.go).
"""

from makisu_tpu_torch.snapshot.copy_op import CopyOperation
from makisu_tpu_torch.snapshot.layer import ContentEntry, Layer, WhiteoutEntry
from makisu_tpu_torch.snapshot.memfs import FSDiff, MemFS, Node
from makisu_tpu_torch.snapshot.walk import (
    WHITEOUT_META_PREFIX,
    WHITEOUT_PREFIX,
    eval_symlinks,
    tarinfo_from_stat,
    walk,
)

__all__ = [
    "CopyOperation", "ContentEntry", "FSDiff", "Layer", "MemFS", "Node",
    "WhiteoutEntry", "WHITEOUT_META_PREFIX", "WHITEOUT_PREFIX",
    "eval_symlinks", "tarinfo_from_stat", "walk",
]
