"""The comparisons that decide ``correct``. Every number is a count of
answers that differ from the reference; every limit is 0, since the
system's guarantee is byte identity (a wrong digest silently splits the
cache it keys).
"""

from __future__ import annotations

import numpy as np

from portbench.reference import gear, layers


def chunk_counts(tar, chunks, want_ends: np.ndarray) -> dict[str, int]:
    """``chunks``: (offset, length, hex digest) of the program's chunk list
    of layer stream ``tar``. Counts the cut ends that are not the
    reference's (either side), the chunks whose digest is not SHA-256 of
    their bytes, and whether the chunks fail to tile the stream."""
    view = memoryview(tar)
    pos = 0
    tiles = True
    bad = 0
    for off, n, hexd in chunks:
        tiles &= off == pos and n > 0
        pos = off + n
        if off < 0 or off + n > len(view) or \
                layers.sha256_hex(view[off:off + n]) != hexd:
            bad += 1
    tiles &= pos == len(view)
    ends = {off + n for off, n, _ in chunks}
    return {"cut_ends": len(ends ^ set(want_ends.tolist())),
            "chunk_digests": bad, "untiled": int(not tiles)}


def want_ends(tar, chunking: dict, device) -> np.ndarray:
    """The reference's cut ends of a layer stream."""
    return gear.cut_ends(tar, chunking["avg_bits"], chunking["min_size"],
                         chunking["max_size"], device)


def control_chunks(tar, chunking: dict, device, block: int) -> list:
    """The control's chunk list of a layer stream: the reference's cuts
    made in independent ``block``-byte pieces (``gear.cut_ends_per_block``)
    with each chunk's SHA-256."""
    ends = gear.cut_ends_per_block(
        tar, chunking["avg_bits"], chunking["min_size"],
        chunking["max_size"], device, block).tolist()
    view = memoryview(tar)
    starts = [0] + ends[:-1]
    return [(a, b - a, layers.sha256_hex(view[a:b]))
            for a, b in zip(starts, ends)]


def add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def limits(counts: dict) -> dict:
    """The result line's ``compared``: each count beside its limit, 0."""
    return {k: {"value": int(v), "limit": 0} for k, v in counts.items()}
