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
// Bound on an H100: the bytes. G of a byte takes 256 values, so a table
// in shared memory replaces the splitmix chain with one load (the
// load/store pipe, not an INT32 op), and the window needs no 32-term
// sum: h_p = (h_{p-1} << 1) + G(b_p) mod 2^32 drops the term that leaves
// the window. Per byte that leaves one byte extract (PRMT), the mask
// test (LOP3 with a predicate result) and setting the word's bit (LOP3):
// 3 ops only the ALU pipe issues (64 lanes per SM per clock), and the
// shift-add (LEA, or IMAD on the FMA pipe). At 3 ALU ops per byte the
// operations take 3 / 64 SM clocks per byte, under the bytes,
// (n read + n/8 written) / 3.35 TB/s.
//
// Design: that least work, per thread. A block of 128 threads owns a
// 16 KiB tile of a row. Its first threads start 16-byte cp.async copies
// of the tile and the 32 bytes before it into shared memory (coalesced:
// neighbouring threads copy neighbouring 16-byte chunks), and build the
// 256-entry G table in shared memory with the splitmix chain while the
// copies fly. Each thread then owns 128 consecutive positions, four
// output words: it walks the 32 bytes before them with
// h = (h << 1) + T[b] from h = 0 (the byte 32 back contributes G << 32,
// which vanishes, so that walk yields the exact history), then its 128
// positions, setting bit s of a word held in a register when
// (h & mask) == 0, and stores whole words. There is no ballot and no
// 32-term sum; the 32-byte walk-in costs 25% more table steps than the
// positions alone. A thread at a row's start has no bytes before it: the
// head's 32 G-values give h = head_g * (2^32 - 1) = -head_g mod 2^32.
// Thread t reads its 16-byte chunks 8(t + 1) + k, k = -2..7; unswizzled,
// the eight threads of a quarter-warp would read one bank group (a
// stride of 128 bytes), so a chunk's slot within its 128-byte row is
// XORed with the row's low 3 bits, and the eight read eight groups.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 4;                         // output words per thread
constexpr int kSpan = 32 * kWords;                // positions per thread
constexpr int kTile = kThreads * kSpan;           // positions per block
constexpr int kRowChunks = kSpan / 16;            // 16-byte chunks per thread
constexpr int kChunks = (kThreads + 1) * kRowChunks;  // + a history row
static_assert(kRowChunks == 8, "the swizzle assumes 8 chunks per row");

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

// Shared-memory slot of logical chunk c: its slot within a row of 8
// chunks XORed with the row's low 3 bits.
__device__ __forceinline__ int swizzle(int c) { return c ^ ((c >> 3) & 7); }

// in: rows x n bytes (16-byte aligned rows), out: rows x n/32 words,
// n % 32 == 0. Logical chunk c of a block holds row bytes
// [tile0 - 128 + 16c, +16): row 0 is history (only chunks 6 and 7, the
// 32 bytes before the tile, are read), row t + 1 is thread t's.
__global__ void __launch_bounds__(kThreads)
gear_bitmap_kernel(const uint8_t* __restrict__ in, uint32_t* __restrict__ out,
                   long long n, uint32_t mask, uint32_t head_g) {
  __shared__ __align__(16) uint4 tile[kChunks];
  __shared__ uint32_t table[256];
  const uint8_t* src = in + static_cast<long long>(blockIdx.y) * n;
  uint32_t* dst = out + static_cast<long long>(blockIdx.y) * (n / 32);
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const int t = threadIdx.x;

  for (int c = kRowChunks - 2 + t; c < kChunks; c += kThreads) {
    const long long p = tile0 - kSpan + 16LL * c;
    uint4* slot = &tile[swizzle(c)];
    if (p >= 0 && p < n) {
      const unsigned sm =
          static_cast<unsigned>(__cvta_generic_to_shared(slot));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sm),
                   "l"(src + p));
    } else {
      *slot = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int b = t; b < 256; b += kThreads) table[b] = gear_value(b);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const long long p0 = tile0 + static_cast<long long>(t) * kSpan;
  if (p0 >= n) return;

  uint32_t h = 0u;
  if (p0 == 0) {
    h = 0u - head_g;
  } else {
#pragma unroll
    for (int k = kRowChunks - 2; k < kRowChunks; ++k) {
      const uint4 v = tile[swizzle(t * kRowChunks + k)];
      const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        h = (h << 1) + table[(q[j >> 2] >> (8 * (j & 3))) & 0xFFu];
    }
  }

  uint32_t words[kWords] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kRowChunks; ++k) {
    const uint4 v = tile[swizzle((t + 1) * kRowChunks + k)];
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      h = (h << 1) + table[(q[j >> 2] >> (8 * (j & 3))) & 0xFFu];
      if ((h & mask) == 0u) words[k >> 1] |= 1u << (16 * (k & 1) + j);
    }
  }
  const long long w0 = p0 >> 5;
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    if (p0 + 32LL * w < n) dst[w0 + w] = words[w];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `in` must be 16-byte aligned.
extern "C" int makisu_gear_bitmap(const void* in, void* out, long long n,
                                  int rows, unsigned mask, unsigned head_g,
                                  void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile),
                  static_cast<unsigned>(rows));
  gear_bitmap_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint32_t*>(out), n, mask,
      head_g);
  return static_cast<int>(cudaGetLastError());
}
