"""Plain Gear content-defined chunking: the cut ends of a whole stream.

Gear walks the stream with h_i = (h_{i-1} << 1) + G[b_i] (mod 2^32) from
h = 0 before the first byte, and a byte whose h has its low ``avg_bits``
bits all zero is a candidate: cut after it. Mod 2^32 a byte k positions
back contributes G[b_{i-k}] << k, which vanishes for k >= 32, so h_i is
the windowed sum over the last 32 bytes; it is computed here for every
position at once, in plain PyTorch (on the card or the CPU), in pieces
that carry 31 bytes of history. The min/max chunk-size policy then runs
over the whole stream's candidates on the host.

Frozen copies: the gear table is ``makisu_tpu_torch/ops/gear.py:54-77``
(splitmix32 of seed + i * golden), the policy is its
``select_boundaries_np`` (``:197-229``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WINDOW = 32
M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SEED = 0x6D616B69  # "maki"
_MIX1 = 0x21F0AAAD
_MIX2 = 0x735A2D97
PIECE = 64 << 20  # stream bytes per piece of the windowed sum


def _splitmix32(x: int) -> int:
    x = (x + _GOLDEN) & M32
    z = x
    z = ((z ^ (z >> 16)) * _MIX1) & M32
    z = ((z ^ (z >> 15)) * _MIX2) & M32
    return (z ^ (z >> 15)) & M32


@functools.lru_cache(maxsize=1)
def gear_table() -> np.ndarray:
    """The 256-entry uint32 gear table."""
    state = _SEED
    vals = []
    for _ in range(256):
        vals.append(_splitmix32(state))
        state = (state + _GOLDEN) & M32
    return np.array(vals, dtype=np.uint32)


def _windowed_sum(g: torch.Tensor) -> torch.Tensor:
    """h[i] = sum_{k<32} g[i-k] << k (mod 2^32), zero before index 0, by
    log doubling: H_2m[i] = H_m[i] + (H_m[i-m] << m)."""
    h = g
    m = 1
    while m < WINDOW:
        shifted = torch.zeros_like(h)
        shifted[m:] = h[:-m]
        h = (h + (shifted << m)) & M32
        m *= 2
    return h


def candidates(data, avg_bits: int, device) -> np.ndarray:
    """Positions p (ascending) whose Gear hash has its low ``avg_bits``
    bits zero: "cut after byte p"."""
    table = torch.from_numpy(gear_table().astype(np.int64)).to(device)
    mask = (1 << avg_bits) - 1
    view = memoryview(data)
    out = []
    for start in range(0, len(view), PIECE):
        lo = max(0, start - (WINDOW - 1))
        seg = np.frombuffer(view[lo:start + PIECE], dtype=np.uint8).copy()
        x = torch.from_numpy(seg).to(device)
        h = _windowed_sum(table[x.long()])
        hits = torch.nonzero((h & mask) == 0).flatten().cpu().numpy() + lo
        out.append(hits[hits >= start])
        del x, h
    if not out:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(out).astype(np.int64)


def select_boundaries(cands: np.ndarray, n: int, min_size: int,
                      max_size: int) -> np.ndarray:
    """The min/max chunk policy over a whole stream's sorted candidates:
    cut end offsets (exclusive), always ending with n. Oversize gaps are
    split at fixed strides from the previous cut."""
    cuts = []
    prev = 0
    for p in np.asarray(cands, dtype=np.int64):
        end = int(p) + 1
        if end - prev < min_size:
            continue
        while end - prev > max_size:
            prev += max_size
            cuts.append(prev)
        if end - prev >= min_size:
            cuts.append(end)
            prev = end
    while n - prev > max_size:
        prev += max_size
        cuts.append(prev)
    if prev < n or n == 0:
        cuts.append(n)
    return np.array(cuts, dtype=np.int64)


def cut_ends(data, avg_bits: int, min_size: int, max_size: int,
             device) -> np.ndarray:
    """The whole stream's chunk ends."""
    return select_boundaries(candidates(data, avg_bits, device), len(data),
                             min_size, max_size)


def cut_ends_per_block(data, avg_bits: int, min_size: int, max_size: int,
                       device, block: int) -> np.ndarray:
    """The control's chunk ends: every ``block`` bytes chunked as a stream
    of its own (no history, no uncut tail carried across a block end), the
    step a parallel chunker would be tempted to take. Breaks the
    guarantee that cuts are a function of the whole stream."""
    view = memoryview(data)
    out = []
    for start in range(0, len(view), block):
        piece = view[start:start + block]
        out.append(cut_ends(piece, avg_bits, min_size, max_size, device)
                   + start)
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)
