"""Gear bitmap kernel (``csrc/gear.cu``) wrapper.

Counterpart of ``makisu_tpu/ops/gear_pallas.py``: one natural-layout
kernel replaces both of its Pallas kernels, ``_gear_kernel`` (stream head
``"zero_bytes"``) and ``_gear_kernel2`` (``"zero_history"``). Its halo
entry starts each row from the 32 bytes before it, as a seq shard of a
longer stream does (``parallel/pipeline.py``; the reference's
``gear_bitmap_with_halo``). A CPU tensor goes to the plain version in
``ops/gear.py``; a CUDA tensor goes to the kernel or raises. There is no
fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from makisu_tpu_torch.ops import _build, backend, gear

# Kernel launches made by this process (a run reads it to show that its
# path went through the kernel); ``halo_launches`` counts those of them
# that took the halo entry.
launches = 0
halo_launches = 0

# Bytes of history the halo entry takes per row: the window (the first
# of them drops out of every hash) in whole 16-byte chunks.
HALO = gear.WINDOW

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("gear").makisu_gear_bitmap
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gear_bitmap(buf: torch.Tensor, avg_bits: int = gear.DEFAULT_AVG_BITS,
                head: str = "zero_history",
                halo: torch.Tensor | None = None,
                timer: backend.KernelTimer | None = None) -> torch.Tensor:
    """Packed candidate bitmap of uint8 ``buf`` [n] or [B, n] (each row
    its own stream, n % 32 == 0) -> uint32 [n // 32] or [B, n // 32].
    ``halo``, uint8 [32] or [B, 32] on ``buf``'s device, holds the 32
    bytes before each row and takes the place of ``head``. On the card
    the buffer and the halo must start on a 16-byte boundary (the kernel
    copies them in 16-byte chunks). On the card ``timer`` times the
    launch (``backend.KernelTimer``) as ``gear_bitmap``."""
    global launches, halo_launches
    if buf.dtype != torch.uint8 or buf.dim() not in (1, 2):
        raise ValueError(f"gear_bitmap takes uint8 [n] or [B, n], got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    n = buf.shape[-1]
    if n % 32:
        raise ValueError(f"stream length {n} not a multiple of 32")
    if not 1 <= avg_bits <= 31:
        raise ValueError(f"avg_bits {avg_bits} out of range 1..31")
    head_g = gear.head_value(head)
    if halo is not None:
        if halo.dtype != torch.uint8 or \
                tuple(halo.shape) != (*buf.shape[:-1], HALO):
            raise ValueError(f"halo must be uint8 {(*buf.shape[:-1], HALO)},"
                             f" got {halo.dtype} {tuple(halo.shape)}")
        if halo.device != buf.device:
            raise ValueError("buffer and halo lie on different devices")
    if buf.device.type == "cpu":
        if halo is not None:
            return gear.gear_bitmap_with_halo(buf, gear.halo_values(halo),
                                              avg_bits)
        return gear.gear_bitmap(buf, avg_bits, head=head)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if not buf.is_contiguous():
        raise ValueError("gear_bitmap needs a contiguous buffer")
    if buf.data_ptr() % 16:
        raise ValueError("gear_bitmap needs a 16-byte aligned buffer")
    if halo is not None and (not halo.is_contiguous()
                             or halo.data_ptr() % 16):
        raise ValueError("gear_bitmap needs a contiguous, 16-byte aligned "
                         "halo")
    rows = buf.shape[0] if buf.dim() == 2 else 1
    if rows > 65535:
        raise ValueError(f"{rows} rows exceed the kernel grid (65535)")
    out = torch.empty((*buf.shape[:-1], n // 32), dtype=torch.uint32,
                      device=buf.device)
    if n == 0 or rows == 0:
        return out
    with torch.cuda.device(buf.device):
        kernel = _kernel()  # built or loaded outside the timed launch
        with backend.timed_launch(timer, "gear_bitmap"):
            err = kernel(buf.data_ptr(), out.data_ptr(), n, rows,
                         (1 << avg_bits) - 1, head_g,
                         None if halo is None else halo.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gear kernel launch failed: CUDA error {err}")
    launches += 1
    if halo is not None:
        halo_launches += 1
    return out
