"""Span SHA-256 kernel (``csrc/sha256.cu``) wrapper and parity probe.

Counterpart of ``makisu_tpu/ops/sha256_pallas.py``. One kernel serves
three entry points: ``sha256_spans`` hashes arbitrary byte spans of one
buffer (the chunk session's route: chunks are spans of its device ring),
``sha256_lanes`` hashes the rows of a [L, CAP] lane buffer as the spans
``(i * CAP, length_i)``, and ``sha256_multi`` hashes spans of several
buffers in one launch (the shared hash service's batch of several
sessions' ring passes). A CPU tensor goes to the plain version in
``ops/sha256.py``; a CUDA tensor goes to the kernel or raises. Chunk
digests are cache identity shared by CPU, TPU and GPU builders, so
before the chunker trusts the kernel, ``parity_probe`` (run by the device
plane's probe, ``backend.backend_ready``) holds it against hashlib once
per process and device and raises on any mismatch; nothing re-routes to
another path.

A span must lie inside its buffer; a lane's length must lie in
[0, CAP - 9]. The plain versions raise for one that does not; the kernel
hashes it as the empty message and sets the launch's own error word.
Every launch allocates its word with its output, and a ``LaunchErrors``
keeps the words of the launches one caller made (a chunk session, a
service batch, or by default the calling thread), so a launch on another
stream or thread never reads or clears this one's error. ``check`` on it
(``check_lengths`` for the calling thread's) raises; its wait is bounded
(``backend.sync_bounded``).
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
import time

import numpy as np
import torch

from makisu_tpu_torch.ops import _build, backend, gear, sha256
from makisu_tpu_torch.utils import events, metrics
from makisu_tpu_torch.utils import logging as log

# Kernel launches made by this process, per entry (a run reads them to
# show that its path went through the kernel): single-buffer launches
# (``sha256_spans``, ``sha256_lanes``) and multi-buffer ones.
launches = 0
multi_launches = 0

_fns: dict[str, object] = {}
_probe_lock = threading.Lock()
_probed: set[str] = set()
_thread = threading.local()  # the calling thread's default LaunchErrors

# Lengths every parity probe covers: empty, one byte, the one-block /
# two-block padding edges, a few blocks, and the largest chunk.
EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 100, gear.DEFAULT_MAX_SIZE)
# Bytes of metadata per span of a multi-buffer launch: base, offset,
# length and request index as int64.
MULTI_META_BYTES = 32

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "makisu_sha256_spans": [_P, _LL, _P, _I, _P, _P, _I, _LL, _P, _P],
    "makisu_sha256_multi": [_P, _P, _I, _P, _I, _LL, _P, _P],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("sha256"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


class LaunchErrors:
    """The error words of the S1 launches one caller made, each copied
    into pinned host memory behind its launch on that launch's stream,
    with an event recorded after the copy. ``check`` waits for those
    events only (``backend.sync_bounded``, "launch error word"), reads
    the words and raises ValueError if any launch met a span outside its
    buffer (or a lane length outside [0, CAP - 9]); it forgets the words
    it read either way. On the CPU nothing is kept: the plain versions
    raise at once."""

    def __init__(self) -> None:
        self._words: list[tuple[torch.Tensor, torch.cuda.Event]] = []
        self._lock = threading.Lock()

    def add(self, word: torch.Tensor) -> None:
        host = torch.empty(1, dtype=torch.int32, pin_memory=True)
        host.copy_(word, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        with self._lock:
            self._words.append((host, done))

    def check(self) -> None:
        with self._lock:
            words, self._words = self._words, []
        bad = 0
        for host, done in words:
            backend.sync_bounded(done, "launch error word")
            bad += int(host[0] != 0)
        if bad:
            raise ValueError(
                f"sha256 kernel: {bad} launch(es) met a span outside its "
                "buffer or a lane length outside [0, capacity - 9]; their "
                "digests are not the messages'")


def thread_errors() -> LaunchErrors:
    """The calling thread's default ``LaunchErrors`` (what a launch
    without ``errors=`` records into, and ``check_lengths`` checks)."""
    errs = getattr(_thread, "errors", None)
    if errs is None:
        errs = _thread.errors = LaunchErrors()
    return errs


def _launch(buf: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
            max_len: int, errors: LaunchErrors | None,
            timer: backend.KernelTimer | None = None) -> torch.Tensor:
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
    word = torch.empty(1, dtype=torch.int32, device=buf.device)
    with torch.cuda.device(buf.device):
        kernel = _kernel("makisu_sha256_spans")
        with backend.timed_launch(timer, "sha256_spans"):
            err = kernel(
                buf.data_ptr(), buf.numel(), offsets.data_ptr(),
                int(offsets.dtype == torch.int64), lengths.data_ptr(),
                out.data_ptr(), spans, max_len, word.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sha256 kernel launch failed: CUDA error "
                               f"{err}")
        (errors if errors is not None else thread_errors()).add(word)
    launches += 1
    return out


def sha256_spans(buf: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor,
                 errors: LaunchErrors | None = None,
                 timer: backend.KernelTimer | None = None) -> torch.Tensor:
    """uint8 ``buf`` [N] + int32 or int64 ``offsets`` [S] + int32
    ``lengths`` [S], each span inside the buffer -> uint32 [S, 8] digest
    words (big-endian word order), in span order. The kernel is fastest
    with spans ordered longest first. On the card a span outside the
    buffer is reported by ``errors.check()`` (default: the calling
    thread's, ``check_lengths``), not here. On the card ``timer`` times
    the launch (``backend.KernelTimer``) as ``sha256_spans``."""
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
    return _launch(buf, offsets, lengths, buf.numel(), errors, timer)


def sha256_lanes(data: torch.Tensor, lengths: torch.Tensor,
                 errors: LaunchErrors | None = None) -> torch.Tensor:
    """uint8 lanes [L, CAP] (CAP % 64 == 0) + int32 lengths [L], each in
    [0, CAP - 9] -> uint32 [L, 8] digest words (big-endian word order).
    On the card a length outside that range is reported by
    ``errors.check()`` (default ``check_lengths``), not here."""
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
    return _launch(data.view(-1), offsets, lengths, cap - 9, errors)


def _multi_meta(bufs: list[torch.Tensor], buf_index: np.ndarray,
               offsets: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
    """The multi-buffer launch's metadata as one int64 host tensor,
    pinned where the buffers lie on the card: [4, S] (each span's
    buffer base address, offset, length and buffer index) followed by
    the buffers' sizes [R]."""
    spans = len(buf_index)
    meta = torch.empty(4 * spans + len(bufs), dtype=torch.int64,
                       pin_memory=bool(bufs) and bufs[0].is_cuda)
    m = meta.numpy()
    bases = np.array([b.data_ptr() for b in bufs], dtype=np.int64)
    m[:spans] = bases[buf_index]
    m[spans:2 * spans] = offsets
    m[2 * spans:3 * spans] = lengths
    m[3 * spans:4 * spans] = buf_index
    m[4 * spans:] = [b.numel() for b in bufs]
    return meta


def sha256_multi(bufs: list[torch.Tensor], buf_index, offsets, lengths,
                 errors: LaunchErrors | None = None,
                 timer: backend.KernelTimer | None = None) -> torch.Tensor:
    """Spans of several uint8 [N_r] buffers in one launch: span i is
    (``offsets[i]``, ``lengths[i]``) of ``bufs[buf_index[i]]``; the
    metadata are host arrays (numpy or CPU tensors). -> uint32 [S, 8]
    digest words in span order. Every buffer lies on one device; a CPU
    one goes to the plain version. On the card a span outside its own
    buffer (or a bad index) is reported by ``errors.check()`` (default
    ``check_lengths``), not here. On the card ``timer`` times the launch
    (``backend.KernelTimer``) as ``sha256_multi``."""
    if not bufs:
        raise ValueError("sha256_multi needs at least one buffer")
    device = bufs[0].device
    for b in bufs:
        if b.dtype != torch.uint8 or b.dim() != 1 or b.device != device:
            raise ValueError(f"sha256_multi takes uint8 [N] buffers on one "
                             f"device, got {b.dtype} {tuple(b.shape)} on "
                             f"{b.device}")
    idx = np.asarray(buf_index, dtype=np.int64)
    offs = np.asarray(offsets, dtype=np.int64)
    lens = np.asarray(lengths, dtype=np.int64)
    if not idx.shape == offs.shape == lens.shape or idx.ndim != 1:
        raise ValueError("buffer indices, offsets and lengths must be [S] "
                         "each")
    if device.type == "cpu":
        return sha256.sha256_multi(bufs, torch.from_numpy(idx),
                                   torch.from_numpy(offs),
                                   torch.from_numpy(lens))
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for b in bufs:
        if b.data_ptr() % 4:
            raise ValueError("sha256 kernel needs 4-byte aligned buffers")
    global multi_launches
    spans = len(idx)
    out = torch.empty((spans, 8), dtype=torch.uint32, device=device)
    if spans == 0:
        return out
    # The metadata cross on the current stream, ahead of the kernel.
    meta = _multi_meta(bufs, idx, offs, lens).to(device, non_blocking=True)
    word = torch.empty(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        kernel = _kernel("makisu_sha256_multi")
        with backend.timed_launch(timer, "sha256_multi"):
            err = kernel(
                meta.data_ptr(), meta.data_ptr() + 8 * 4 * spans,
                len(bufs), out.data_ptr(), spans,
                max(b.numel() for b in bufs), word.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sha256 multi-buffer kernel launch failed: "
                               f"CUDA error {err}")
        (errors if errors is not None else thread_errors()).add(word)
    multi_launches += 1
    return out


def check_lengths(device: torch.device) -> None:
    """Raise ValueError if a kernel launch this thread made on the card
    without ``errors=`` met a span outside its buffer or a lane length
    outside [0, CAP - 9] since the last check (its words are then
    forgotten). Waits for those launches only; a no-op on the CPU, where
    the plain versions raise at once."""
    if torch.device(device).type != "cuda":
        return
    thread_errors().check()


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
    mismatch. Its copies go through pinned memory and its readback is a
    bounded wait ("parity probe readback"). The device plane's probe
    (``backend.backend_ready``) runs it in its ``first_dispatch`` phase.

    Its cost and verdict are exported as the reference's are:
    ``makisu_device_parity_probe_seconds{bucket=max_len, result}`` and a
    ``device_probe`` event."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    with _probe_lock:
        if key in _probed:
            return
        t0 = time.monotonic()
        buf, offsets, lengths = probe_spans(max_len)
        errors = LaunchErrors()
        try:
            got = _probe_digests(device, buf, offsets, lengths, errors)
            backend.note_first_launch("sha256", len(buf),
                                      time.monotonic() - t0)
            errors.check()
            bad = np.flatnonzero((got != hashlib_span_words(
                buf, offsets, lengths)).any(1))
            if len(bad):
                i = int(bad[0])
                raise RuntimeError(
                    f"sha256 kernel parity probe on {device}: {len(bad)} "
                    f"spans differ from hashlib (first: offset "
                    f"{int(offsets[i])}, length {int(lengths[i])})")
        except Exception as e:
            _note_probe(t0, max_len, len(lengths), str(e))
            raise
        _probed.add(key)
        _note_probe(t0, max_len, len(lengths), "")
        log.info("sha256 parity probe passed on %s (%d spans)", device,
                 len(lengths))


def _probe_digests(device: torch.device, buf: np.ndarray,
                   offsets: np.ndarray, lengths: np.ndarray,
                   errors: LaunchErrors) -> np.ndarray:
    """The parity probe's spans hashed on ``device`` -> uint32 [S, 8]
    host words. On the card the inputs cross from pinned memory and the
    digests come back into it, behind one event with a bounded wait."""
    host = [torch.from_numpy(a) for a in (buf, offsets, lengths)]
    if device.type != "cuda":
        return sha256_spans(*host).numpy()
    dev = [t.pin_memory().to(device, non_blocking=True) for t in host]
    digests = sha256_spans(*dev, errors=errors)
    out = torch.empty(digests.shape, dtype=torch.uint32, pin_memory=True)
    out.copy_(digests, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    backend.sync_bounded(done, "parity probe readback")
    return out.numpy()


def _note_probe(t0: float, bucket: int, spans: int, error: str) -> None:
    """Export one parity probe's cost and verdict (the telemetry is
    around the probe; the probe's own error still raises)."""
    seconds = time.monotonic() - t0
    metrics.gauge_set("makisu_device_parity_probe_seconds", seconds,
                      bucket=bucket, result="failed" if error else "ok")
    events.emit("device_probe", phase="sha_parity_probe",
                status="error" if error else "done",
                seconds=round(seconds, 4), bucket=bucket, lanes=spans)
