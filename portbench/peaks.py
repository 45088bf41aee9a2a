"""The card's peaks and the kernels' least work: the yardstick of every
``*_roofline`` metric.

Frozen copies of ``chip_smoke.py:333-340`` (the memory rate and each
kernel's least INT32 work, derived in its kernel's header) and
``chip_smoke.py:359-378`` (``max_sm_hz``, ``int32_ops_per_s``, ``bound``).
Counting rule: each input byte is read once and each output byte written
once, whatever a kernel reads again.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# Least INT32 work of each function, derived in its kernel's header:
# (ops only the ALU pipe issues, ops the ALU or the FMA pipe issues).
GEAR_OPS_PER_BYTE = (3, 1)
SHA_OPS_PER_BLOCK = (1040, 360)
SPAN_META_BYTES = 8   # int32 ring offset + int32 length per span
DIGEST_BYTES = 32
GEAR_BITMAP_BYTES_PER_BYTE = 1 / 8  # one candidate bit out per input byte


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_hz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def int32_ops_per_s(sms: int, sm_hz: float) -> float:
    """The ALU pipe's INT32 rate: SMs x 64 lanes x the maximum SM clock
    nvidia-smi reports. The issue limit (4 schedulers x 32 lanes per SM,
    which adds on the FMA pipe can also fill) is twice this."""
    return sms * 64 * sm_hz


def bound_s(nbytes: float, alu_ops: float, any_ops: float,
            int_rate: float) -> tuple[float, str]:
    """Least seconds for the bytes at the memory rate and for the ops:
    ALU-only ops at the ALU rate, all ops at the issue limit."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(alu_ops / int_rate, (alu_ops + any_ops) / (2 * int_rate))
    return max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def gear_bound_s(stream_bytes: int, int_rate: float) -> tuple[float, str]:
    """G1 over ``stream_bytes`` of layer stream: every byte read once,
    its candidate bit written once."""
    alu, either = GEAR_OPS_PER_BYTE
    return bound_s(stream_bytes * (1 + GEAR_BITMAP_BYTES_PER_BYTE),
                   alu * stream_bytes, either * stream_bytes, int_rate)


def sha_bound_s(chunk_bytes: int, chunks: int, live_blocks: int,
                int_rate: float) -> tuple[float, str]:
    """S1 over ``chunks`` spans: their bytes read once, each span's
    metadata read and its digest written once, the ops of every live
    block."""
    alu, either = SHA_OPS_PER_BLOCK
    return bound_s(chunk_bytes + chunks * (SPAN_META_BYTES + DIGEST_BYTES),
                   alu * live_blocks, either * live_blocks, int_rate)
