"""Kernel variants held against the kernels of ``csrc/`` on one card.

    python -m makisu_tpu_torch.tools.kernel_variants   # from the repo root

Builds each variant from an edited copy of its kernel's source under
``build/torch_kernels/variants/`` (``csrc/`` is not touched), checks it
bit-exact against the plain versions and hashlib, and prints the CUPTI
kernel time of kernel and variant in turns (base, variant, variant,
base, twice) at the shapes ``chip_smoke.py`` uses:

- ``gear_table16``: G1 with 16 copies of the G table in shared memory,
  thread t reading copy t % 16, so no two lanes of a half-warp meet in
  a bank; on random bytes, on text-like bytes and on a binary stretch of
  the smoke layer.
- ``sha256_reassoc``: S1 with h + K + W and d + h + K + W summed off the
  rounds' e and a chains, on the chunks of one ring pass of the layer.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs
from makisu_tpu_torch.chunker.cdc import BLOCK, ChunkSession
from makisu_tpu_torch.ops import _build, gear, gear_cuda, sha256_cuda

VARIANTS = {
    "gear_table16": ("gear", [
        ("constexpr int kThreads = 128;",
         "constexpr int kThreads = 128;\nconstexpr int kCopies = 16;"),
        ("__shared__ uint32_t table[256];",
         "__shared__ uint32_t table[256 * kCopies];"),
        ("  for (int b = t; b < 256; b += kThreads) table[b] = gear_value(b);",
         "  for (int b = t; b < 256; b += kThreads)\n"
         "    for (int r = 0; r < kCopies; ++r)"
         " table[b * kCopies + r] = gear_value(b);\n"
         "  const int copy = t & (kCopies - 1);"),
        ("table[(q[j >> 2] >> (8 * (j & 3))) & 0xFFu]",
         "table[((q[j >> 2] >> (8 * (j & 3))) & 0xFFu) * kCopies + copy]"),
    ]),
    "sha256_reassoc": ("sha256", [
        ("    const uint32_t big_s1 = rotr(e, 6)",
         "    const uint32_t hkw = h + kK[t] + wt;\n"
         "    const uint32_t dhkw = d + hkw;\n"
         "    const uint32_t big_s1 = rotr(e, 6)"),
        ("const uint32_t t1 = h + big_s1 + ch + kK[t] + wt;",
         "const uint32_t t1 = hkw + big_s1 + ch;"),
        ("    e = d + t1;", "    e = dhkw + big_s1 + ch;"),
    ]),
}


def cupti_kernel_ms(fn, key: str, reps: int, name: str) -> float:
    """Mean CUPTI duration of the kernels whose name holds ``key`` over
    ``reps`` calls of ``fn`` (after one warm-up call): the kernel's own
    time, whatever the host's enqueue costs. CUPTI has missed launches
    of a later profiler session in a process, so the loop starts after a
    pause, a trace that holds fewer than all of them is taken again, up
    to three times, and the best must hold at least half."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    best: list = []
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [e - s for s, e, n in cs.trace_events(prof, f"{name}{attempt}")
                if key in n]
        if len(durs) > len(best):
            best = durs
        if len(best) == reps:
            break
    cs.check(2 * len(best) >= reps, f"{key}: CUPTI traced {len(best)} kernels "
          f"of {reps} calls")
    return sum(best) / len(best) / 1e3


def build_variant(name: str):
    """Compile a variant; returns its kernel entry point, bound like the
    base kernel's, and the ptxas report lines."""
    base, edits = VARIANTS[name]
    src = (_build.CSRC / f"{base}.cu").read_text()
    for old, new in edits:
        if src.count(old) == 0:
            raise RuntimeError(f"{name}: {old!r} not in {base}.cu")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(out / f"{name}.cu")], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{log}")
    like = gear_cuda._kernel() if base == "gear" else sha256_cuda._kernel()
    fn = getattr(ctypes.CDLL(str(out / f"{name}.so")), like.__name__)
    fn.argtypes, fn.restype = like.argtypes, like.restype
    return fn, [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]


def main() -> None:
    dev = torch.device("cuda")
    _build.build_all()
    g_var, g_log = build_variant("gear_table16")
    s_var, s_log = build_variant("sha256_reassoc")
    print(json.dumps({"ptxas": {"gear_table16": g_log,
                                "sha256_reassoc": s_log}}), flush=True)
    g_base, s_base = gear_cuda._kernel(), sha256_cuda._kernel()

    tar, _ = cs.make_layer_tar(np, cs.LAYER_BYTES)
    ends = cs.plain_cuts(torch, np, tar, dev)
    ring = ChunkSession.RING_BLOCKS * BLOCK
    offsets, lengths = cs.ring_pass_spans(np, ends, ring)
    buf = torch.frombuffer(bytearray(tar[:ring]), dtype=torch.uint8).to(dev)
    o, ln = (torch.from_numpy(a).to(dev) for a in (offsets, lengths))
    truth = sha256_cuda.hashlib_span_words(tar, offsets, lengths)
    n = 4 * cs.MIB + 128
    blocks = {
        "random": np.random.default_rng(1).integers(0, 256, size=n,
                                                    dtype=np.uint8),
        "text": np.frombuffer(tar, np.uint8, n, 100 * cs.MIB),
        "binary": np.frombuffer(tar, np.uint8, n, len(tar) - n),
    }
    blocks = {k: torch.from_numpy(v.copy()).to(dev) for k, v in
              blocks.items()}
    for _ in range(2):
        for label in ("base", "variant", "variant", "base"):
            gear_cuda._fn = g_var if label == "variant" else g_base
            sha256_cuda._fn = s_var if label == "variant" else s_base
            got = sha256_cuda.sha256_spans(buf, o, ln).cpu().numpy()
            cs.check((got == truth).all(), f"sha256 {label} differs")
            row = {"label": label, "sha256_ms": cupti_kernel_ms(
                lambda: sha256_cuda.sha256_spans(buf, o, ln),
                "sha256_spans_kernel", 5, "variant_trace")}
            for k, x in blocks.items():
                for bits in (gear.DEFAULT_AVG_BITS, 4):
                    cs.check(torch.equal(
                        gear_cuda.gear_bitmap(x, bits).cpu(),
                        gear.gear_bitmap(x, bits).cpu()),
                        f"gear {label} differs on {k}")
                row[f"gear_{k}_ms"] = cupti_kernel_ms(
                    lambda: gear_cuda.gear_bitmap(x),
                    "gear_bitmap_kernel", 50, "variant_trace")
            print(json.dumps(row), flush=True)
    gear_cuda._fn = sha256_cuda._fn = None
    print(cs.nvidia_smi("name,power.limit"), flush=True)


if __name__ == "__main__":
    main()
