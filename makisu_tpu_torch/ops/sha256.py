"""Lane-parallel SHA-256: constants and the plain PyTorch version.

SHA-256 is sequential within one message (64-byte blocks chain through
the compression function), so the port hashes L independent messages
("lanes") side by side: every word of hash state is a vector of shape
[L], every round is an elementwise op over all lanes, and a loop walks
the block axis with per-lane masking for ragged message lengths.

This is the plain version of the span SHA-256 kernel
(``ops/sha256_cuda.py``): the CPU tests run it, and ``chip_smoke.py``
holds the kernel against it (and hashlib) on the card. ``sha256_lanes``
loops only to the largest live block count of the batch, not to the lane
capacity; ``sha256_spans`` gathers spans of one buffer into lanes of
similar block counts and hashes each group with it.

Arithmetic: CPU ``torch.uint32`` has no add, shift or compare, so words
are ``int64`` holding values in [0, 2^32), masked with ``& 0xFFFFFFFF``
after each add; digests leave as ``torch.uint32`` [L, 8] big-endian words.
"""

from __future__ import annotations

import numpy as np
import torch

# FIPS 180-4 round constants and initial state.
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

_M32 = 0xFFFFFFFF


# Rotation amounts of Sigma0 (row 0, applied to a) and Sigma1 (row 1,
# applied to e), so one stacked op computes both.
_BIG_SIGMA = ((2, 6), (13, 11), (22, 25))


def _sigma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> s) for x in [0, 2^32): x is
    doubled into both halves of an int64, so each rotation is one shift;
    bits r..r+31 (r <= 31) never reach the sign extension."""
    xx = x | (x << 32)
    return (((xx >> r1) ^ (xx >> r2)) & _M32) ^ (x >> s)


def num_blocks(lengths: torch.Tensor) -> torch.Tensor:
    """Live 64-byte block count per lane after padding."""
    return (lengths.to(torch.int64) + 9 + 63) // 64


def _apply_padding(msg_bytes: torch.Tensor, idx: torch.Tensor,
                   lengths: torch.Tensor,
                   total: torch.Tensor) -> torch.Tensor:
    """The SHA-256 padding formula: mask the tail, place the 0x80 marker,
    write the 8-byte big-endian bit length. ``idx`` is each byte's
    absolute message offset, ``total`` each lane's padded byte count
    (num_blocks * 64). Returns int64 bytes."""
    ln = lengths.to(torch.int64)[:, None]
    msg = torch.where(idx < ln, msg_bytes.to(torch.int64), 0)
    msg = torch.where(idx == ln, 0x80, msg)
    off = idx - (total[:, None] - 8)  # 0..7 inside the length field
    bitlen = ln << 3
    len_byte = (bitlen >> ((7 - off.clamp(0, 7)) << 3)) & 0xFF
    return torch.where((off >= 0) & (off < 8), len_byte, msg)


def bytes_to_words(msg: torch.Tensor) -> torch.Tensor:
    """bytes [L, NB*64] -> big-endian int64 words [L, NB, 16]."""
    L, n = msg.shape
    b = msg.reshape(L, n // 64, 16, 4).to(torch.int64)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | \
        b[..., 3]


def _schedule(words: torch.Tensor) -> torch.Tensor:
    """The 64-word message schedule of every block at once, round
    constants added: big-endian words [L, NB, 16] -> [NB, 64, L] holding
    W[t] + K[t] (not reduced mod 2^32). The schedule depends only on the
    block, so it is computed outside the block chain, two words a step
    (W[t] needs W[t-2]); counterpart of the reference's
    ``_schedule_rounds16``."""
    L, nb, _ = words.shape
    W = torch.empty((nb, 64, L), dtype=torch.int64, device=words.device)
    W[:, :16] = words.permute(1, 2, 0)
    for t in range(16, 64, 2):
        W[:, t:t + 2] = (_sigma(W[:, t - 2:t], 17, 19, 10)
                         + W[:, t - 7:t - 5]
                         + _sigma(W[:, t - 15:t - 13], 7, 18, 3)
                         + W[:, t - 16:t - 14]) & _M32
    return W + torch.from_numpy(_K.astype(np.int64)).to(W.device)[:, None]


def _round(a, b, c, d, e, f, g, h, wk, rot):
    """One SHA-256 round (``wk`` = W[t] + K[t], ``rot`` the _BIG_SIGMA
    amounts as three [2, 1] tensors); returns the renamed (a..h)."""
    ae = torch.stack([a, e])
    xx = ae | (ae << 32)  # both halves: one shift per rotation
    big = ((xx >> rot[0]) ^ (xx >> rot[1]) ^ (xx >> rot[2])) & _M32
    t1 = h + big[1] + (((f ^ g) & e) ^ g) + wk
    maj = (a & b) | (c & (a | b))
    return ((t1 + big[0] + maj) & _M32, a, b, c, (d + t1) & _M32, e, f, g)


def _compress(state: list, wk: torch.Tensor, rot) -> list:
    """One block over all lanes: state is 8 int64 [L] words, ``wk`` the
    block's scheduled words [64, L]."""
    v = tuple(state)
    for w in wk.unbind(0):
        v = _round(*v, w, rot)
    return [(s + x) & _M32 for s, x in zip(state, v)]


@torch.inference_mode()
def sha256_lanes(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Ragged uint8 lanes [L, CAP] + int32 lengths [L] -> uint32 [L, 8]
    digests (big-endian word order). CAP % 64 == 0 and every length lies
    in [0, CAP - 9] so the padding fits in the lane (ValueError
    otherwise); bytes past a lane's length are ignored."""
    L, cap = data.shape
    if cap % 64:
        raise ValueError(f"lane capacity {cap} not a multiple of 64")
    lengths = lengths.to(torch.int64)
    if L and not 0 <= int(lengths.min()) <= int(lengths.max()) <= cap - 9:
        raise ValueError(f"lane lengths must lie in [0, {cap - 9}]")
    nb = num_blocks(lengths)
    live = int(nb.max()) if L else 0
    state = [torch.full((L,), int(h), dtype=torch.int64, device=data.device)
             for h in _H0]
    if live:
        idx = torch.arange(live * 64, device=data.device)[None, :]
        wk = _schedule(bytes_to_words(
            _apply_padding(data[:, :live * 64], idx, lengths, nb * 64)))
        rot = [torch.tensor(r, device=data.device)[:, None]
               for r in _BIG_SIGMA]
        for b in range(live):
            new = _compress(state, wk[b], rot)
            keep = b < nb
            state = [torch.where(keep, n, s) for n, s in zip(new, state)]
    return torch.stack(state, dim=1).to(torch.uint32)


# Lane bytes gathered per sha256_lanes call of sha256_spans (bounds the
# int64 intermediates of the plain version to some tens of MiB).
_SPAN_BATCH_BYTES = 1 << 21


@torch.inference_mode()
def sha256_spans(buf: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """uint8 ``buf`` [N] + offsets [S] + lengths [S], each span inside
    the buffer (ValueError otherwise) -> uint32 [S, 8] digests in span
    order. Spans are gathered into lanes grouped by block count (each
    group's counts lie within a factor of two), so the cost follows the
    live blocks, not S times the longest span."""
    n = buf.numel()
    offs = offsets.to(torch.int64)
    lens = lengths.to(torch.int64)
    # int64: index_put has no uint32 kernel.
    out = torch.empty((len(offs), 8), dtype=torch.int64, device=buf.device)
    if not len(offs):
        return out.to(torch.uint32)
    if int(offs.min()) < 0 or int(lens.min()) < 0 or \
            int((offs + lens).max()) > n:
        raise ValueError(f"spans must lie inside the buffer of {n} bytes")
    nb = num_blocks(lens)
    group = torch.floor(torch.log2(nb.to(torch.float64))).to(torch.int64)
    src = buf if n else torch.zeros(1, dtype=torch.uint8, device=buf.device)
    for g in torch.unique(group).tolist():
        idx = torch.nonzero(group == g).flatten()
        cap = 64 * int(nb[idx].max())
        step = max(1, _SPAN_BATCH_BYTES // cap)
        for i in range(0, len(idx), step):
            sel = idx[i:i + step]
            pos = offs[sel, None] + torch.arange(cap, device=buf.device)
            lanes = src[pos.clamp_(max=src.numel() - 1)]
            out[sel] = sha256_lanes(lanes, lens[sel].to(torch.int32)).to(
                torch.int64)
    return out.to(torch.uint32)


@torch.inference_mode()
def sha256_multi(bufs: list[torch.Tensor], buf_index: torch.Tensor,
                 offsets: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Spans of several uint8 [N_r] buffers: span i is (``offsets[i]``,
    ``lengths[i]``) of ``bufs[buf_index[i]]``, each inside its own
    buffer (ValueError otherwise) -> uint32 [S, 8] digests in span order.
    The plain version of the multi-buffer kernel entry: the spans' bytes
    are gathered end to end into one buffer and hashed there by
    ``sha256_spans``, so the cost follows the live blocks of all spans
    together, not one pass per buffer."""
    idx = buf_index.to(torch.int64).tolist()
    offs = offsets.to(torch.int64).tolist()
    lens = lengths.to(torch.int64).tolist()
    device = bufs[0].device if bufs else torch.device("cpu")
    if any(not 0 <= r < len(bufs) for r in idx):
        raise ValueError(f"buffer indices must lie in [0, {len(bufs)})")
    for r, o, n in zip(idx, offs, lens):
        if o < 0 or n < 0 or o + n > bufs[r].numel():
            raise ValueError(f"spans must lie inside the buffer of "
                             f"{bufs[r].numel()} bytes")
    pieces = [bufs[r][o:o + n] for r, o, n in zip(idx, offs, lens)]
    flat = torch.cat(pieces) if pieces else \
        torch.zeros(0, dtype=torch.uint8, device=device)
    starts = torch.tensor([0] + lens, dtype=torch.int64).cumsum(0)[:-1]
    return sha256_spans(flat, starts.to(device), torch.tensor(
        lens, dtype=torch.int32, device=device))


def digest_bytes(words: np.ndarray) -> list[bytes]:
    """uint32 [L, 8] digest words -> list of 32-byte digests."""
    return [w.astype(">u4").tobytes() for w in np.asarray(words)]


def digest_hex(words: np.ndarray) -> list[str]:
    return [d.hex() for d in digest_bytes(words)]
