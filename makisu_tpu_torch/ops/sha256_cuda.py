"""Lane SHA-256 kernel (``csrc/sha256.cu``) wrapper and parity probe.

Counterpart of ``makisu_tpu/ops/sha256_pallas.py``. A CPU tensor goes to
the plain version in ``ops/sha256.py``; a CUDA tensor goes to the kernel
or raises. Chunk digests are cache identity shared by CPU, TPU and GPU
builders, so before the chunker trusts the kernel with a (lanes, cap)
shape, ``parity_probe`` holds it against hashlib at that shape once per
process and raises on any mismatch; nothing re-routes to another path.

A lane's length must lie in [0, CAP - 9]. The plain version raises for
one that does not; the kernel hashes such a lane as the empty message
and sets its device's error flag, which ``check_lengths`` reads (it
synchronises, so callers check where they wait for the digests anyway).
"""

from __future__ import annotations

import ctypes
import hashlib
import threading

import numpy as np
import torch

from makisu_tpu_torch.ops import _build, sha256

# Kernel launches made by this process (a run reads it to show that its
# path went through the kernel).
launches = 0

_fn = None
_flags: dict[torch.device, torch.Tensor] = {}  # one error word per device
_probe_lock = threading.Lock()
_probed: set[tuple[int, int, str]] = set()

# Lengths every parity probe covers (clamped to cap - 9): empty, one
# byte, the one-block/two-block padding edges, and a full lane.
EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 100)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("sha256").makisu_sha256_lanes
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _flag(device: torch.device) -> torch.Tensor:
    if device not in _flags:
        _flags[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _flags[device]


def sha256_lanes(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """uint8 lanes [L, CAP] (CAP % 64 == 0) + int32 lengths [L], each in
    [0, CAP - 9] -> uint32 [L, 8] digest words (big-endian word order).
    On the card a length outside that range is reported by
    ``check_lengths``, not here."""
    global launches
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
    if not (data.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("sha256_lanes needs contiguous tensors")
    if data.data_ptr() % 16:
        raise ValueError("lane buffer must be 16-byte aligned")
    out = torch.empty((lanes, 8), dtype=torch.uint32, device=data.device)
    if lanes == 0:
        return out
    with torch.cuda.device(data.device):
        err = _kernel()(data.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                        lanes, cap, _flag(data.device).data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sha256 kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def check_lengths(device: torch.device) -> None:
    """Raise ValueError if a kernel launch on ``device`` met a length
    outside [0, CAP - 9] since the last check, and clear the flag.
    Synchronises with the current stream; a no-op on the CPU, where the
    plain version raises at once."""
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
        raise ValueError("sha256 kernel: a lane length lay outside "
                         "[0, capacity - 9]; its digest is not the "
                         "message's")


def probe_inputs(lanes: int, cap: int,
                 seed: int = 0xEC0) -> tuple[np.ndarray, np.ndarray]:
    """Seeded random lanes with ragged lengths covering EDGE_LENGTHS and
    cap - 9 (the parity probe's inputs)."""
    rng = np.random.default_rng(seed ^ lanes ^ cap)
    data = rng.integers(0, 256, size=(lanes, cap), dtype=np.uint8)
    lengths = rng.integers(0, cap - 8, size=lanes).astype(np.int32)
    edge = [min(e, cap - 9) for e in (*EDGE_LENGTHS, cap - 9)]
    lengths[:min(len(edge), lanes)] = edge[:lanes]
    return data, lengths


def hashlib_words(data: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """hashlib digests of each lane as uint32 [L, 8] big-endian words."""
    raw = b"".join(hashlib.sha256(data[i, :int(n)].tobytes()).digest()
                   for i, n in enumerate(lengths))
    return np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(-1, 8)


def parity_probe(lanes: int, cap: int, device: torch.device) -> None:
    """Hold the kernel against hashlib once per process for this
    (lanes, cap) shape on ``device``; raises RuntimeError on a mismatch."""
    key = (lanes, cap, str(device))
    with _probe_lock:
        if key in _probed:
            return
        data, lengths = probe_inputs(lanes, cap)
        got = sha256_lanes(torch.from_numpy(data).to(device),
                           torch.from_numpy(lengths).to(device)).cpu().numpy()
        check_lengths(device)
        bad = np.flatnonzero((got != hashlib_words(data, lengths)).any(1))
        if len(bad):
            i = int(bad[0])
            raise RuntimeError(
                f"sha256 kernel parity probe {lanes}x{cap} on {device}: "
                f"{len(bad)} lanes differ from hashlib (first: lane {i}, "
                f"length {int(lengths[i])})")
        _probed.add(key)
