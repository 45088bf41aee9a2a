"""Gear bitmap kernel (``csrc/gear.cu``) wrapper.

Counterpart of ``makisu_tpu/ops/gear_pallas.py``: one natural-layout
kernel replaces both of its Pallas kernels, ``_gear_kernel`` (stream head
``"zero_bytes"``) and ``_gear_kernel2`` (``"zero_history"``). A CPU
tensor goes to the plain version in ``ops/gear.py``; a CUDA tensor goes
to the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from makisu_tpu_torch.ops import _build, gear

# Kernel launches made by this process (a run reads it to show that its
# path went through the kernel).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("gear").makisu_gear_bitmap
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gear_bitmap(buf: torch.Tensor, avg_bits: int = gear.DEFAULT_AVG_BITS,
                head: str = "zero_history") -> torch.Tensor:
    """Packed candidate bitmap of uint8 ``buf`` [n] or [B, n] (each row
    its own stream, n % 32 == 0) -> uint32 [n // 32] or [B, n // 32].
    On the card the buffer must start on a 16-byte boundary (the kernel
    copies it in 16-byte chunks)."""
    global launches
    if buf.dtype != torch.uint8 or buf.dim() not in (1, 2):
        raise ValueError(f"gear_bitmap takes uint8 [n] or [B, n], got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    n = buf.shape[-1]
    if n % 32:
        raise ValueError(f"stream length {n} not a multiple of 32")
    if not 1 <= avg_bits <= 31:
        raise ValueError(f"avg_bits {avg_bits} out of range 1..31")
    head_g = gear.head_value(head)
    if buf.device.type == "cpu":
        return gear.gear_bitmap(buf, avg_bits, head=head)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if not buf.is_contiguous():
        raise ValueError("gear_bitmap needs a contiguous buffer")
    if buf.data_ptr() % 16:
        raise ValueError("gear_bitmap needs a 16-byte aligned buffer")
    rows = buf.shape[0] if buf.dim() == 2 else 1
    if rows > 65535:
        raise ValueError(f"{rows} rows exceed the kernel grid (65535)")
    out = torch.empty((*buf.shape[:-1], n // 32), dtype=torch.uint32,
                      device=buf.device)
    if n == 0 or rows == 0:
        return out
    with torch.cuda.device(buf.device):
        err = _kernel()(buf.data_ptr(), out.data_ptr(), n, rows,
                        (1 << avg_bits) - 1, head_g,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gear kernel launch failed: CUDA error {err}")
    launches += 1
    return out
