"""Span SHA-256 kernel (``csrc/sha256.cu``) wrapper and parity probe.

Counterpart of ``makisu_tpu/ops/sha256_pallas.py``. One kernel serves two
entry points: ``sha256_spans`` hashes arbitrary byte spans of one buffer
(the chunk session's route: chunks are spans of its device ring), and
``sha256_lanes`` hashes the rows of a [L, CAP] lane buffer as the spans
``(i * CAP, length_i)``. A CPU tensor goes to the plain version in
``ops/sha256.py``; a CUDA tensor goes to the kernel or raises. Chunk
digests are cache identity shared by CPU, TPU and GPU builders, so
before the chunker trusts the kernel, ``parity_probe`` holds it against
hashlib once per process and device and raises on any mismatch; nothing
re-routes to another path.

A span must lie inside its buffer; a lane's length must lie in
[0, CAP - 9]. The plain versions raise for one that does not; the kernel
hashes it as the empty message and sets its device's error flag, which
``check_lengths`` reads (it synchronises, so callers check where they
wait for the digests anyway).
"""

from __future__ import annotations

import ctypes
import hashlib
import threading

import numpy as np
import torch

from makisu_tpu_torch.ops import _build, gear, sha256

# Kernel launches made by this process (a run reads it to show that its
# path went through the kernel).
launches = 0

_fn = None
_flags: dict[torch.device, torch.Tensor] = {}  # one error word per device
_probe_lock = threading.Lock()
_probed: set[str] = set()

# Lengths every parity probe covers: empty, one byte, the one-block /
# two-block padding edges, a few blocks, and the largest chunk.
EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 100, gear.DEFAULT_MAX_SIZE)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("sha256").makisu_sha256_spans
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _flag(device: torch.device) -> torch.Tensor:
    if device not in _flags:
        _flags[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _flags[device]


def _launch(buf: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
            max_len: int) -> torch.Tensor:
    global launches
    if not (buf.is_contiguous() and offsets.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("sha256 kernel needs contiguous tensors")
    if buf.data_ptr() % 4:
        raise ValueError("sha256 kernel needs a 4-byte aligned buffer")
    spans = offsets.shape[0]
    out = torch.empty((spans, 8), dtype=torch.uint32, device=buf.device)
    if spans == 0:
        return out
    with torch.cuda.device(buf.device):
        err = _kernel()(buf.data_ptr(), buf.numel(), offsets.data_ptr(),
                        int(offsets.dtype == torch.int64), lengths.data_ptr(),
                        out.data_ptr(), spans, max_len,
                        _flag(buf.device).data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sha256 kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def sha256_spans(buf: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """uint8 ``buf`` [N] + int32 or int64 ``offsets`` [S] + int32
    ``lengths`` [S], each span inside the buffer -> uint32 [S, 8] digest
    words (big-endian word order), in span order. The kernel is fastest
    with spans ordered longest first. On the card a span outside the
    buffer is reported by ``check_lengths``, not here."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError(f"sha256_spans takes a uint8 [N] buffer, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    if offsets.dtype not in (torch.int32, torch.int64) or offsets.dim() != 1:
        raise ValueError(f"offsets must be int32 or int64 [S], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != offsets.shape:
        raise ValueError(f"lengths must be int32 {tuple(offsets.shape)}, "
                         f"got {lengths.dtype} {tuple(lengths.shape)}")
    if not buf.device == offsets.device == lengths.device:
        raise ValueError("buffer, offsets and lengths lie on different "
                         "devices")
    if buf.device.type == "cpu":
        return sha256.sha256_spans(buf, offsets, lengths)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    return _launch(buf, offsets, lengths, buf.numel())


def sha256_lanes(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """uint8 lanes [L, CAP] (CAP % 64 == 0) + int32 lengths [L], each in
    [0, CAP - 9] -> uint32 [L, 8] digest words (big-endian word order).
    On the card a length outside that range is reported by
    ``check_lengths``, not here."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"sha256_lanes takes uint8 [L, CAP], got "
                         f"{data.dtype} {tuple(data.shape)}")
    lanes, cap = data.shape
    if cap % 64:
        raise ValueError(f"lane capacity {cap} not a multiple of 64")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (lanes,):
        raise ValueError(f"lengths must be int32 [{lanes}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != data.device:
        raise ValueError("data and lengths lie on different devices")
    if data.device.type == "cpu":
        return sha256.sha256_lanes(data, lengths)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if not data.is_contiguous():
        raise ValueError("sha256_lanes needs contiguous tensors")
    offsets = torch.arange(lanes, dtype=torch.int64,
                           device=data.device) * cap
    return _launch(data.view(-1), offsets, lengths, cap - 9)


def check_lengths(device: torch.device) -> None:
    """Raise ValueError if a kernel launch on ``device`` met a span
    outside its buffer or a lane length outside [0, CAP - 9] since the
    last check, and clear the flag. Synchronises with the current
    stream; a no-op on the CPU, where the plain versions raise at once."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _flags:
        return
    flag = _flags[device]
    if flag.item():
        flag.zero_()
        raise ValueError("sha256 kernel: a span lay outside its buffer or "
                         "a lane length outside [0, capacity - 9]; its "
                         "digest is not the message's")


def probe_inputs(lanes: int, cap: int,
                 seed: int = 0xEC0) -> tuple[np.ndarray, np.ndarray]:
    """Seeded random lanes with ragged lengths covering the short
    EDGE_LENGTHS and cap - 9."""
    rng = np.random.default_rng(seed ^ lanes ^ cap)
    data = rng.integers(0, 256, size=(lanes, cap), dtype=np.uint8)
    lengths = rng.integers(0, cap - 8, size=lanes).astype(np.int32)
    edge = [min(e, cap - 9) for e in (*EDGE_LENGTHS[:-1], cap - 9)]
    lengths[:min(len(edge), lanes)] = edge[:lanes]
    return data, lengths


def probe_spans(max_len: int = gear.DEFAULT_MAX_SIZE, seed: int = 0xEC1
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The parity probe's spans over one seeded random buffer: every
    offset 0-63 mod 64 with each EDGE_LENGTHS value below ``max_len``
    and a random length, and four ``max_len`` spans of all four
    alignments that end in the buffer's last 4 bytes (the last one at
    its end). Returns (buffer, offsets int64, lengths int32)."""
    rng = np.random.default_rng(seed)
    short = [e for e in EDGE_LENGTHS if e < max_len]
    offs, lens = [], []
    for lead in range(64):
        for k, e in enumerate((*short, int(rng.integers(0, 4096)))):
            offs.append(64 * (len(short) + 1) * lead + 64 * k + lead)
            lens.append(e)
    top = max(o + n for o, n in zip(offs, lens))
    n = top + max_len + 4
    for lead in range(4):
        offs.append(n - max_len - lead)
        lens.append(max_len)
    buf = rng.integers(0, 256, size=n, dtype=np.uint8)
    return buf, np.array(offs, np.int64), np.array(lens, np.int32)


def hashlib_words(data: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """hashlib digests of each lane as uint32 [L, 8] big-endian words."""
    raw = b"".join(hashlib.sha256(data[i, :int(n)].tobytes()).digest()
                   for i, n in enumerate(lengths))
    return np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(-1, 8)


def hashlib_span_words(buf, offsets: np.ndarray,
                       lengths: np.ndarray) -> np.ndarray:
    """hashlib digests of spans of ``buf`` (bytes-like) as uint32 [S, 8]
    big-endian words."""
    mv = memoryview(buf)
    raw = b"".join(hashlib.sha256(mv[int(o):int(o) + int(n)]).digest()
                   for o, n in zip(offsets, lengths))
    return np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(-1, 8)


def parity_probe(device: torch.device,
                 max_len: int = gear.DEFAULT_MAX_SIZE) -> None:
    """Hold the kernel against hashlib once per process and device on
    the spans of ``probe_spans(max_len)``; raises RuntimeError on a
    mismatch."""
    key = str(device)
    with _probe_lock:
        if key in _probed:
            return
        buf, offsets, lengths = probe_spans(max_len)
        got = sha256_spans(torch.from_numpy(buf).to(device),
                           torch.from_numpy(offsets).to(device),
                           torch.from_numpy(lengths).to(device)
                           ).cpu().numpy()
        check_lengths(device)
        bad = np.flatnonzero((got != hashlib_span_words(
            buf, offsets, lengths)).any(1))
        if len(bad):
            i = int(bad[0])
            raise RuntimeError(
                f"sha256 kernel parity probe on {device}: {len(bad)} spans "
                f"differ from hashlib (first: offset {int(offsets[i])}, "
                f"length {int(lengths[i])})")
        _probed.add(key)
