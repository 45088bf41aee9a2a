"""Gear content-defined chunking: constants and the plain PyTorch version.

Gear CDC walks a byte stream with the recurrence

    h_i = (h_{i-1} << 1) + G[b_i]   (mod 2^32)

and cuts a chunk boundary after byte i when ``h_i & mask == 0``. Mod 2^32
the contribution of a byte k positions back is ``G[b_{i-k}] << k``, which
vanishes for k >= 32, so the sequential hash equals a 32-byte windowed
sum

    h_i = sum_{k=0}^{31} G[b_{i-k}] << k   (mod 2^32)

computed here for every position at once in 5 log-doubling steps
(window 1 -> 2 -> 4 -> 8 -> 16 -> 32):

    H_1[i]  = G[b_i]
    H_2m[i] = H_m[i] + (H_m[i-m] << m)

This module is the plain version of the Gear bitmap kernel
(``ops/gear_cuda.py``): the CPU tests run it, and ``chip_smoke.py`` holds
the kernel against it on the card. Candidate boundaries leave the device
as a bit-packed bitmap, one uint32 word per 32 input bytes (1/8 of the
input bytes); the min/max chunk-size policy is a host pass over the
candidates (``chunker/cdc.py``).

Arithmetic: CPU ``torch.uint32`` has no add, shift or compare, so every
function here computes in ``int64`` holding values in [0, 2^32) and
masks with ``& 0xFFFFFFFF``; results leave as ``torch.uint32`` so the bit
pattern at the API boundary is the kernel's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WINDOW = 32  # bytes of history that survive mod 2^32

# Default chunking geometry: 8 KiB average (mask of 13 bits), 2 KiB min,
# 64 KiB max. Cache identity: changing any of these changes every chunk.
DEFAULT_AVG_BITS = 13
DEFAULT_MIN_SIZE = 2 * 1024
DEFAULT_MAX_SIZE = 64 * 1024

# Stream-head conventions of the bitmap (what precedes position 0):
# "zero_history" treats G as 0 before the stream (gear_hash exactly);
# "zero_bytes" treats the stream as preceded by zero bytes, G(0) each.
HEADS = ("zero_history", "zero_bytes")

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SEED = 0x6D616B69  # "maki"
_MIX1 = 0x21F0AAAD
_MIX2 = 0x735A2D97


def _splitmix32(x: int) -> int:
    x = (x + _GOLDEN) & _M32
    z = x
    z = ((z ^ (z >> 16)) * _MIX1) & _M32
    z = ((z ^ (z >> 15)) * _MIX2) & _M32
    return (z ^ (z >> 15)) & _M32


@functools.lru_cache(maxsize=1)
def gear_table() -> np.ndarray:
    """Deterministic 256-entry uint32 gear table (stable across versions:
    cache keys derived from it must never change)."""
    state = _SEED
    vals = []
    for _ in range(256):
        vals.append(_splitmix32(state))
        state = (state + _GOLDEN) & _M32
    return np.array(vals, dtype=np.uint32)


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for z in [0, 2^32) without int64 overflow: the
    constant is split into 16-bit halves so no partial product passes
    2^48."""
    lo = z * (c & 0xFFFF)
    hi = (z * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _gear_value(data: torch.Tensor) -> torch.Tensor:
    """G[b] computed arithmetically, bit-identical to ``gear_table()[b]``:
    table index i holds splitmix32 of ``seed + i*GOLDEN``, so the lookup
    is a mix chain with no gather. uint8 in, int64 in [0, 2^32) out."""
    x = (_mul32(data.to(torch.int64), _GOLDEN) + _SEED) & _M32
    z = (x + _GOLDEN) & _M32
    z = _mul32(z ^ (z >> 16), _MIX1)
    z = _mul32(z ^ (z >> 15), _MIX2)
    return z ^ (z >> 15)


def _shift_seq(h: torch.Tensor, m: int) -> torch.Tensor:
    """h[..., i-m] with zero fill at the left edge."""
    pad = torch.zeros(*h.shape[:-1], m, dtype=h.dtype, device=h.device)
    return torch.cat([pad, h[..., :-m]], dim=-1)


def _windowed_sum(g: torch.Tensor) -> torch.Tensor:
    """The log-doubling window accumulation over per-byte G-values: the
    cache-identity-bearing Gear recurrence, zero history before index 0."""
    h = g
    m = 1
    while m < WINDOW:
        h = (h + (_shift_seq(h, m) << m)) & _M32
        m *= 2
    return h


def gear_hash(data: torch.Tensor) -> torch.Tensor:
    """Per-position Gear hashes (int64 in [0, 2^32)) for uint8 [..., N],
    zero history before index 0."""
    return _windowed_sum(_gear_value(data))


def boundary_mask(h: torch.Tensor,
                  avg_bits: int = DEFAULT_AVG_BITS) -> torch.Tensor:
    """Candidate-boundary bool mask from per-position hashes."""
    return (h & ((1 << avg_bits) - 1)) == 0


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., N] -> uint32 [..., N//32] little-bit-order bitmap: bit s
    of word w is position 32*w + s."""
    n = bits.shape[-1]
    if n % 32:
        raise ValueError(f"bit count {n} not a multiple of 32")
    b = bits.reshape(*bits.shape[:-1], n // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, dtype=torch.int64, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint32)


def head_value(head: str) -> int:
    """The G-value a stream's head convention puts before index 0."""
    if head not in HEADS:
        raise ValueError(f"unknown head {head!r} (one of {HEADS})")
    return int(gear_table()[0]) if head == "zero_bytes" else 0


def halo_values(halo: torch.Tensor) -> torch.Tensor:
    """The ``halo_g`` of ``gear_bitmap_with_halo`` from the bytes before a
    segment, uint8 [..., k] with k >= WINDOW - 1: the G-values of the
    last WINDOW - 1 of them (int64)."""
    return _gear_value(halo[..., halo.shape[-1] - (WINDOW - 1):])


def gear_bitmap_with_halo(data: torch.Tensor, halo_g: torch.Tensor,
                          avg_bits: int = DEFAULT_AVG_BITS) -> torch.Tensor:
    """gear_bitmap for a stream segment: ``halo_g`` holds the G-values of
    the 31 positions before it (zeros at a stream start). uint8 [..., N]
    with N % 32 == 0 -> uint32 [..., N//32]."""
    g = torch.cat([halo_g.to(torch.int64), _gear_value(data)], dim=-1)
    h = _windowed_sum(g)[..., WINDOW - 1:]
    return pack_bits(boundary_mask(h, avg_bits))


def gear_bitmap(data: torch.Tensor, avg_bits: int = DEFAULT_AVG_BITS,
                head: str = "zero_history") -> torch.Tensor:
    """uint8 [..., N] -> packed candidate bitmap uint32 [..., N//32], each
    row its own stream with the ``head`` convention (see HEADS)."""
    halo = torch.full((*data.shape[:-1], WINDOW - 1), head_value(head),
                      dtype=torch.int64, device=data.device)
    return gear_bitmap_with_halo(data, halo, avg_bits)


def unpack_bits_np(words: np.ndarray, n: int) -> np.ndarray:
    """uint32 [..., W] bitmap -> bool [..., n] (host side, numpy)."""
    le_bytes = np.asarray(words, dtype="<u4").view(np.uint8)
    bits = np.unpackbits(le_bytes.reshape(*words.shape[:-1], -1),
                         axis=-1, bitorder="little")
    return bits[..., :n].astype(bool)


def candidates_np(words: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Set-bit positions p with lo <= p < hi of a flat uint32 bitmap,
    ascending. Equal to ``np.nonzero(unpack_bits_np(words, hi))[0]``
    restricted to [lo, hi), but decodes only the nonzero words (about one
    in 256 at the default geometry)."""
    words = np.asarray(words, dtype="<u4").reshape(-1)
    nz = np.flatnonzero(words)
    if not len(nz):
        return np.zeros(0, dtype=np.int64)
    bits = np.unpackbits(words[nz].view(np.uint8).reshape(-1, 4),
                         axis=1, bitorder="little").astype(bool)
    pos = (nz.astype(np.int64)[:, None] * 32 + np.arange(32))[bits]
    return pos[(pos >= lo) & (pos < hi)]


def select_boundaries_np(
    candidates: np.ndarray,
    n: int,
    min_size: int = DEFAULT_MIN_SIZE,
    max_size: int = DEFAULT_MAX_SIZE,
) -> np.ndarray:
    """Test oracle for the min/max chunk policy, applied to a whole
    stream's candidate list (``chunker.cdc.ChunkSession`` applies it
    streaming; the two must never differ).

    candidates: sorted positions p meaning "cut after byte p"
    n:          stream length
    Returns cut end offsets (exclusive), always ending with n. Oversize
    gaps are split at fixed strides from the previous cut.
    """
    cuts = []
    prev = 0
    for p in np.asarray(candidates, dtype=np.int64):
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


def gear_hash_ref(data: bytes) -> np.ndarray:
    """Pure-Python sequential reference (for tests): h_i for every i."""
    table = gear_table()
    out = np.empty(len(data), dtype=np.uint32)
    h = 0
    for i, byte in enumerate(data):
        h = ((h << 1) + int(table[byte])) & _M32
        out[i] = h
    return out
