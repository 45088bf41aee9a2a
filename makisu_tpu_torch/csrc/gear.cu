// Gear candidate-boundary bitmap for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute the same
// bitmap in two layouts shaped by the TPU's (8, 128) tiling:
//   makisu_tpu/ops/gear_pallas.py  _gear_kernel   (sublane-major halo rows,
//       zero-byte halo at the stream head: head = G(0))
//   makisu_tpu/ops/gear_pallas.py  _gear_kernel2  (natural layout with a
//       carry across a sequential grid; zero-G-value history: head = 0)
// Here one natural-layout kernel takes the head's G-value as an argument
// and reproduces either exactly.
//
// For every byte position p of a row (stream) it computes the 32-byte
// window Gear hash
//     h_p = sum_{k<32} G(b_{p-k}) << k   (mod 2^32)
// with G the splitmix chain of makisu_tpu_torch/ops/gear.py::_gear_value,
// tests (h_p & mask) == 0, and packs the results little-bit-order, one
// uint32 word per 32 positions (bit s of word w is position 32*w + s).
// The bitmap is 1/8 of the input bytes.
//
// Design: a block of 256 threads owns 256 consecutive positions. It
// computes G once per byte into shared memory for those positions and
// the 31 before them (read from global memory, or the head value before
// the row's start), so no block depends on another: there is no restage
// transpose and no carry between blocks. Each thread then folds its
// 32-value window with the sequential recurrence h = (h << 1) + G, and
// one warp ballot yields exactly one output word (lane s sets bit s).
//
// Bound on an H100: the least work for this function, not this kernel's.
// G of a byte takes 256 values, so a table in shared memory replaces the
// splitmix chain with one load (the load/store pipe, not an INT32 op),
// and the window needs no 32-term sum: h_p = (h_{p-1} << 1) + G(b_p)
// mod 2^32 drops the term that leaves the window. Per byte that leaves
// one byte extract (PRMT), the mask test (LOP3 with a predicate result)
// and setting the word's bit (LOP3): 3 ops only the ALU pipe issues (64
// lanes per SM per clock), and the shift-add (LEA, or IMAD on the FMA
// pipe). At 3 ALU ops per byte the operations take 3 / 64 SM clocks per
// byte, under the bytes, (n read + n/8 written) / 3.35 TB/s: G1 is
// bytes-bound. This kernel does far more: the 9-op chain per byte (once
// for each of 256 + 31 positions a block loads) and 32 shift-adds per
// position over shared memory; loads are single bytes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 32;
constexpr int kThreads = 256;

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSeed = 0x6D616B69u;
constexpr uint32_t kMix1 = 0x21F0AAADu;
constexpr uint32_t kMix2 = 0x735A2D97u;

__device__ __forceinline__ uint32_t gear_value(uint32_t b) {
  uint32_t z = b * kGolden + kSeed + kGolden;
  z = (z ^ (z >> 16)) * kMix1;
  z = (z ^ (z >> 15)) * kMix2;
  return z ^ (z >> 15);
}

// in: rows x n bytes, out: rows x n/32 words, n % 32 == 0.
__global__ void __launch_bounds__(kThreads)
gear_bitmap_kernel(const uint8_t* __restrict__ in, uint32_t* __restrict__ out,
                   long long n, uint32_t mask, uint32_t head_g) {
  __shared__ uint32_t g[kWindow - 1 + kThreads];
  const uint8_t* src = in + static_cast<long long>(blockIdx.y) * n;
  uint32_t* dst = out + static_cast<long long>(blockIdx.y) * (n / 32);
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  const int t = threadIdx.x;
  const long long p = base + t;

  g[kWindow - 1 + t] = p < n ? gear_value(src[p]) : 0u;
  if (t < kWindow - 1) {
    const long long q = base - (kWindow - 1) + t;
    g[t] = q >= 0 ? gear_value(src[q]) : head_g;
  }
  __syncthreads();
  // n % 32 == 0, so a warp is wholly inside the row or wholly past it.
  if (base + (t & ~31) >= n) return;

  uint32_t h = 0;
#pragma unroll
  for (int k = 0; k < kWindow; ++k) h = (h << 1) + g[t + k];
  const unsigned bits = __ballot_sync(0xffffffffu, (h & mask) == 0u);
  if ((t & 31) == 0) dst[p >> 5] = bits;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int makisu_gear_bitmap(const void* in, void* out, long long n,
                                  int rows, unsigned mask, unsigned head_g,
                                  void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(rows));
  gear_bitmap_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint32_t*>(out), n, mask,
      head_g);
  return static_cast<int>(cudaGetLastError());
}
